"""Serving driver: a teacher-forced prompt, then batched greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Counterpart of ``repro/launch/serve.py``, with its CLI and defaults (the
reduced preset of ``--arch``).  As there, the prompt is fed through
``decode_step`` one token at a time, which fills the ring-buffer KV
cache (and, for jamba-v0.1-52b's mamba blocks, the SSM state and conv
window; for xlstm-350m's blocks, their recurrent states), and the model
then decodes greedily.  The dense archs, the MoE archs
(qwen3-moe-235b-a22b, arctic-480b), the hybrid jamba-v0.1-52b,
xlstm-350m and the encoder-decoder whisper-tiny are served.  For
whisper-tiny without frames the loop is the reference's: the
cross-attention's ``ck`` / ``cv`` caches hold ``cache_len`` rows of
zeros, which no reference code writes, so its decoder never sees an
encoder.  Given ``frames`` (precomputed frame embeddings, the
reference's stub frontend), ``generate`` runs the encoder once and
fills every decoder layer's ``ck`` / ``cv`` with the keys and values
the teacher-forced forward's cross-attention takes
(``transformer.fill_cross_cache``).  The recurrent states start from
zeros, as the reference's cache does: an xLSTM block's stabiliser ``m``
too, where its prefill starts it at -1e30 (``models/xlstm.py``).  Runs
on the card unless ``--device cpu``.  The weights are drawn by
``init_params`` from ``--seed``, and so is the prompt (from a
``torch.Generator``, not the reference's ``jax.random``).
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from repro_torch.configs import get_arch
from repro_torch.core import pytree as pt
from repro_torch.device import resolve_device
from repro_torch.models import (decode_cache_specs, decode_step,
                                fill_cross_cache, init_params, model_specs)


class Generation(NamedTuple):
    tokens: torch.Tensor      # (B, tokens) greedy tokens
    prompt_s: float           # host clock over the prompt's decode steps
    decode_s: float           # host clock over the greedy decode steps
    prompt_logits: torch.Tensor  # (B, 1, V) logits after the prompt


def _clock(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def generate(params, cfg, prompt, tokens: int, cache_len: int,
             frames=None) -> Generation:
    """Feed ``prompt`` (B, P) through the decode path, then decode
    ``tokens`` greedy tokens, as the reference's serve loop does: the
    argmax after the prompt is fed first, and each step's argmax is
    kept.  An encoder-decoder's cross-attention attends over zero
    ``ck`` / ``cv`` of ``cache_len`` rows, as the reference's, or, given
    ``frames`` (B, T, d), over the encoder's keys and values of them
    (module docstring); the encoder's run counts in ``prompt_s``."""
    B, P = prompt.shape
    dev = prompt.device
    dtype = params["embed"]["embedding"].dtype
    enc_len = 0
    if cfg.encoder_decoder:
        enc_len = cache_len if frames is None else frames.shape[1]
    elif frames is not None:
        raise ValueError(f"{cfg.name} takes no frames")
    # KV caches in the params' dtype, recurrent states (mamba, xLSTM) in
    # f32
    cache = pt.tmap(lambda s: torch.zeros(
        s.shape, dtype=dtype if "seq" in s.axes else torch.float32,
        device=dev), decode_cache_specs(cfg, B, cache_len, enc_len))
    t0 = _clock(dev)
    if frames is not None:
        fill_cross_cache(params, frames, cache, cfg)
    for t in range(P):
        logits, cache = decode_step(
            params, {"tokens": prompt[:, t:t + 1], "t": t}, cache, cfg)
    t1 = _clock(dev)
    prompt_logits = logits
    out = []
    tok = torch.argmax(logits, dim=-1)
    for t in range(P, P + tokens):
        logits, cache = decode_step(params, {"tokens": tok, "t": t}, cache,
                                    cfg)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok[:, 0])
    toks = torch.stack(out, dim=1) if out else prompt.new_zeros((B, 0))
    return Generation(toks, t1 - t0, _clock(dev) - t1, prompt_logits)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    gen = torch.Generator().manual_seed(args.seed)
    params = init_params(model_specs(cfg), gen, device=dev)
    B = args.batch
    prompt = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                           generator=gen).to(dev)
    res = generate(params, cfg, prompt, args.tokens, args.cache_len)
    print(f"prefill({args.prompt_len} tok): {res.prompt_s:.2f}s")
    print(f"decoded {args.tokens} tokens x batch {B} in {res.decode_s:.2f}s "
          f"({args.tokens / max(res.decode_s, 1e-9):.1f} tok/s/seq)")
    for b in range(B):
        print(f"  seq{b}: {res.tokens[b].tolist()}")
    return res


if __name__ == "__main__":
    main()
