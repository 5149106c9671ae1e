"""End-to-end federated training driver for the LM stack.

Federated fine-tuning of a dense, an MoE, the hybrid, the xLSTM or the
encoder-decoder architecture (the reduced preset unless ``--full-size``)
with FedDANE / FedAvg / FedProx / variants from the core library:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --rounds 20 --devices-per-round 4 --local-epochs 2 --algo feddane
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-moe-235b-a22b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch jamba-v0.1-52b --layers 1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch xlstm-350m --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
      --full-size --num-devices 8 --devices-per-round 2 --local-epochs 1 \\
      --samples-per-device 16 --rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train --full-size \\
      --num-devices 8 --devices-per-round 2 --local-epochs 1 \\
      --samples-per-device 16 --rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
      --full-size --num-devices 8 --devices-per-round 2 --local-epochs 1 \\
      --samples-per-device 16 --rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu

Counterpart of ``repro/launch/train.py``, with its flags and defaults,
plus ``--device`` (the card unless ``--device cpu``; raises without one)
and ``--local-solver`` (``FederatedConfig.local_solver``).  Data: the
procedural federated corpus of ``data.leaf_like`` (per-device
character-role Markov chains), the reference's tokens and labels bit for
bit.  At full width (qwen1.5-0.5b, 464 M params in f32) one 80 GB card
holds 2 devices a round, not 4.  The weights are drawn by
``init_params`` from ``--seed`` (a ``torch.Generator``, not the
reference's ``jax.random``).  The trainer's
loss runs with ``remat="none"`` (``torch.func.grad`` refuses
checkpoints); on the card its attention is K7 and its backward, one
launch of each a layer for all the selected clients of a local step.
Round times come from CUDA events on the card (the host clock on the
CPU); checkpoints go through ``checkpoint/store.py`` every
``--ckpt-every`` rounds.  The MoE archs (qwen3-moe-235b-a22b,
arctic-480b) train at the reduced preset, cut to at most 4 experts and
top-2 (``ModelConfig.reduced``); their loss adds the blocks' load-balance
aux.  So does jamba-v0.1-52b's, whose reduced preset keeps whole repeats
of its 8-block pattern (``--layers 1``: 8 layers, 7 of them mamba, at
d=128 and state N=8); on the card its mamba blocks' scan runs K8 and its
gradient K8-bwd, once a layer for all the clients of a local step.
xlstm-350m's reduced preset keeps whole repeats of its (sLSTM, mLSTM)
pattern (at least 4 layers; at d=128, 4 heads: dk=64, dh=32), and
``--full-size`` takes all 24 layers (405 M params); on the card its
scans run K9 and K10 and their gradients K9-bwd and K10-bwd, once a
layer for all the clients of a local step.  whisper-tiny (the
encoder-decoder; 4 + 4 layers, 56 M params at ``--full-size``) trains
as the reference's trainer drives it: the decoder on the token data, the
encoder on zero frames of the tokens' length (a stub frontend); on the
card its three attentions a layer run K7 and K7-bwd.  The patch frontend
is refused as not yet ported (``steps.check_trainable``).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, List, NamedTuple

import torch

from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer
from repro_torch.core.client import SOLVER_MODES
from repro_torch.data.batching import FederatedData
from repro_torch.data.leaf_like import generate_shakespeare_like
from repro_torch.device import resolve_device
from repro_torch.launch.steps import check_trainable
from repro_torch.models import init_params, model_specs, param_count
from repro_torch.models import transformer


def make_lm_fed_data(num_devices: int, seq_len: int, batch_size: int,
                     samples_cap: int, seed: int,
                     device=None) -> FederatedData:
    """Each device's first ``seq_len`` tokens and labels of the
    Shakespeare-like corpus, batched on ``device`` (the card unless
    ``device="cpu"``)."""
    devices = generate_shakespeare_like(
        num_devices=num_devices, seed=seed, sample_cap=samples_cap)
    out = [{"tokens": d["tokens"][:, :seq_len],
            "labels": d["labels"][:, :seq_len]} for d in devices]
    return FederatedData(out, batch_size=batch_size, name="fed_lm",
                         device=device)


def make_lm_loss(cfg):
    """The trainer's loss over a ``(b, seq_len + 1)`` batch: the first
    ``seq_len`` positions, no remat; an encoder-decoder's encoder takes
    zero frames (b, seq_len, d) in f32, as the reference's trainer feeds
    it."""
    check_trainable(cfg)

    def loss_fn(params, batch):
        b = {"tokens": batch["tokens"][:, :-1],
             "labels": batch["labels"][:, :-1]}
        if cfg.encoder_decoder:
            b["frames"] = torch.zeros(b["tokens"].shape + (cfg.d_model,),
                                      dtype=torch.float32,
                                      device=b["tokens"].device)
        return transformer.loss_fn(params, b, cfg, remat="none")

    return loss_fn


class TrainResult(NamedTuple):
    cfg: Any
    trainer: FederatedTrainer
    state: Any                  # the last round's FederatedState
    losses: List[float]         # the global loss after each round
    round_ms: List[float]       # each round (CUDA events on the card)


def _timer(dev):
    """``stop()`` of a round timer started now: CUDA events on the card,
    the host clock on the CPU; ms."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()

        def stop():
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        return stop
    t0 = time.perf_counter()
    return lambda: (time.perf_counter() - t0) * 1e3


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--algo", default="feddane",
                    choices=("fedavg", "fedprox", "feddane",
                             "feddane_pipelined", "feddane_decayed",
                             "inexact_dane", "scaffold"))
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--num-devices", type=int, default=16)
    ap.add_argument("--devices-per-round", type=int, default=4)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--mu", type=float, default=0.01)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--samples-per-device", type=int, default=32)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full (not reduced) architecture")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--local-solver", default="auto", choices=SOLVER_MODES)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full_size:
        cfg = cfg.reduced(num_layers=args.layers, d_model=args.d_model,
                          vocab_size=args.vocab)
    specs = model_specs(cfg)
    print(f"arch={cfg.name} params~{param_count(specs):,} on {dev}")
    if cfg.encoder_decoder:
        print("note: audio/VLM archs use stub frontends; federated LM "
              "training here drives the decoder on token data only")

    data = make_lm_fed_data(args.num_devices, args.seq_len + 1,
                            args.batch_size, args.samples_per_device,
                            args.seed, device=dev)
    fed = FederatedConfig(
        algorithm=args.algo, num_devices=args.num_devices,
        devices_per_round=args.devices_per_round,
        local_epochs=args.local_epochs, local_batch_size=args.batch_size,
        learning_rate=args.lr, mu=args.mu, seed=args.seed,
        local_solver=args.local_solver)
    trainer = FederatedTrainer(make_lm_loss(cfg), data, fed, device=dev)
    params = init_params(specs, torch.Generator().manual_seed(args.seed),
                         device=dev)

    st = trainer.init(params)
    del params
    losses, round_ms = [], []
    for r in range(args.rounds):
        stop = _timer(dev)
        st = trainer.round(st)
        round_ms.append(stop())
        losses.append(trainer.global_loss(st.params))
        print(f"round {st.round:4d} comm {st.comm_rounds:4d} "
              f"loss {losses[-1]:.4f}  ({round_ms[-1]:.1f} ms)")
        if args.ckpt_dir and (r + 1) % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, st.params, step=st.round)
            print(f"  checkpoint -> {path}")
    print(f"done: {args.rounds} rounds in {sum(round_ms) / 1e3:.1f}s")
    return TrainResult(cfg, trainer, st, losses, round_ms)


if __name__ == "__main__":
    main()
