"""Model assembly for the LM stack: specs, loss, prefill and decode.

Counterpart of ``repro/models/transformer.py`` for the ``attn``,
``attn_moe``, ``mamba``, ``mamba_moe``, ``mlstm`` and ``slstm``
patterns: the dense archs (qwen1.5-0.5b, yi-9b, minitron-8b,
phi4-mini-3.8b), the MoE archs (qwen3-moe-235b-a22b, arctic-480b), whose
blocks run ``models/moe.py``'s ``moe_ffn`` in place of the SwiGLU FFN,
the hybrid jamba-v0.1-52b, whose mamba blocks run ``models/ssm.py``'s
``mamba_mixer`` in place of attention (K8 on the card) and decode
through ``mamba_decode_step`` on a cache of the SSM state ``h`` and the
conv window, and xlstm-350m, whose self-contained blocks (no FFN) are
``models/xlstm.py``'s mixers (K9 and K10 on the card) and decode on a
cache of the recurrent states (C, n, m and c, n, m, h); and the
encoder-decoder whisper-tiny (``frontend="frames"``): an encoder stack
of non-causal ``attn`` blocks over precomputed frame embeddings, RoPE
over the frame positions, and decoder blocks that add a cross-attention
(``ln_x``, a bias-free ``xattn``: q from the decoder, k and v from the
encoder's output, no RoPE, non-causal: K7 at S != T on the card), each
block with the biased GELU MLP (``layers.gelu_mlp``) in place of the
SwiGLU FFN; its decode cache adds ``ck`` / ``cv``, the cross-attention's
keys and values over the encoder's ``enc_len`` rows.  The
parameter tree keeps the reference's keys and stacked layout
(``embed/embedding``, ``stack/pos_0/attn/wq`` of shape ``[R, d, H, hd]``,
...), so ``models.param.params_from_numpy`` carries the reference's
weights across unchanged.  The layer stack is a Python loop over the
``R`` stacked layers (the reference's ``lax.scan``), each layer under the
reference's remat policy: ``"none"``; ``"full"``, a
``torch.utils.checkpoint`` of the layer (recompute everything from its
input); ``"dots"``, a selective checkpoint that keeps the matrix
products (``aten.mm``, the reference's dots without batch dims) and
recomputes the rest.  All three give the same values, and take every
block kind: under ``"full"`` a mamba layer's scan runs twice on the card
(K8 in the forward and in its recomputation) and its backward once
(K8-bwd, from the recomputation's chunk states), and an xLSTM layer's
scan runs twice (K9 or K10) and its backward once (K9-bwd from the
recomputation's chunk states, K10-bwd from its every-step states).
Checkpoints need
plain ``torch.autograd``: ``torch.func.grad`` refuses them, so the
federated trainer's loss runs with ``remat="none"``, as the reference's
``launch/train.py`` does.  ``prefill`` and ``decode_step`` run under
``torch.inference_mode()``.

Public entry points (functions over param trees):

- ``model_specs(cfg)``                        parameter ParamSpec tree
- ``forward_hidden(params, batch, cfg, remat)`` final hidden states
- ``loss_fn(params, batch, cfg, remat)``      mean token cross-entropy
                                              (+ the MoE blocks' aux)
- ``prefill(params, batch, cfg)``             last-position logits
- ``decode_step(params, batch, cache, cfg)``  one-token decode
- ``decode_cache_specs(cfg, batch, cache_len, enc_len)`` cache ParamSpec
                                              tree
- ``fill_cross_cache(params, frames, cache, cfg)`` the decode cache's
                                              ``ck`` / ``cv`` from frames

The patch frontend (internvl2-26b) is refused as not yet ported.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs import base as cb
from repro_torch.configs.base import ModelConfig, _not_ported
from repro_torch.core import pytree as pt
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe, ssm, xlstm
from repro_torch.models.param import ParamSpec

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

#: The block kinds the port's model takes.
_PORTED_KINDS = (cb.ATTN, cb.ATTN_MOE, cb.MAMBA, cb.MAMBA_MOE, cb.MLSTM,
                 cb.SLSTM)
_ATTN_KINDS = (cb.ATTN, cb.ATTN_MOE)
#: The xLSTM blocks: ``ln1`` and the mixer alone, no FFN.
_XLSTM_SPECS = {cb.MLSTM: xlstm.mlstm_specs, cb.SLSTM: xlstm.slstm_specs}


#: The (frontend, encoder_decoder) pairs the port takes: token ids into
#: a decoder-only stack, or frame embeddings into an encoder-decoder.
_PORTED_INPUTS = (("none", False), ("frames", True))


def _check_ported(cfg: ModelConfig) -> None:
    for kind in cfg.pattern:
        if kind not in _PORTED_KINDS:
            raise _not_ported(f"{cfg.name}: block kind {kind!r}")
    if (cfg.frontend, cfg.encoder_decoder) not in _PORTED_INPUTS:
        raise _not_ported(f"{cfg.name}: frontend {cfg.frontend!r} with "
                          f"encoder_decoder={cfg.encoder_decoder}")


def _block_specs(kind: str, cfg: ModelConfig, *, cross: bool = False
                 ) -> dict:
    """One block's specs; ``cross`` adds the decoder's cross-attention
    (``ln_x``, a bias-free ``xattn``)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    s = {"ln1": L.norm_spec(d)}
    if kind in _XLSTM_SPECS:
        s[kind] = _XLSTM_SPECS[kind](cfg)
        return s  # self-contained block
    if kind in _ATTN_KINDS:
        s["attn"] = attn.attention_specs(d, cfg.num_heads, cfg.num_kv_heads,
                                         hd, cfg.qkv_bias)
    else:
        s["mamba"] = ssm.mamba_specs(cfg)
    if cross:
        s["ln_x"] = L.norm_spec(d)
        s["xattn"] = attn.attention_specs(d, cfg.num_heads,
                                          cfg.num_kv_heads, hd)
    s["ln2"] = L.norm_spec(d)
    if kind in (cb.ATTN_MOE, cb.MAMBA_MOE):
        s["moe"] = moe.moe_specs(d, cfg.d_ff, cfg.moe)
    elif cfg.encoder_decoder:
        s["mlp"] = L.gelu_mlp_specs(d, cfg.d_ff)
    else:
        s["ffn"] = L.swiglu_ffn_specs(d, cfg.d_ff)
    return s


def _stack(spec: ParamSpec, repeats: int) -> ParamSpec:
    return ParamSpec((repeats,) + spec.shape, ("layers",) + spec.axes,
                     init=spec.init, scale=spec.scale)


def _stack_specs(cfg: ModelConfig, *, cross: bool = False) -> dict:
    repeats = cfg.num_layers // len(cfg.pattern)
    return {f"pos_{p}": pt.tmap(lambda s: _stack(s, repeats),
                                _block_specs(kind, cfg, cross=cross))
            for p, kind in enumerate(cfg.pattern)}


def _encoder_stack_specs(cfg: ModelConfig) -> dict:
    """The encoder's ``num_encoder_layers`` attention blocks, stacked."""
    return {"pos_0": pt.tmap(lambda s: _stack(s, cfg.num_encoder_layers),
                             _block_specs(cb.ATTN, cfg))}


def model_specs(cfg: ModelConfig) -> dict:
    _check_ported(cfg)
    s: dict = {
        "embed": L.embed_specs(cfg.vocab_size, cfg.d_model),
        "final_norm": L.norm_spec(cfg.d_model),
        "stack": _stack_specs(cfg, cross=cfg.encoder_decoder),
    }
    if not cfg.tie_embeddings:
        s["head"] = L.head_specs(cfg.d_model, cfg.vocab_size)
    if cfg.encoder_decoder:
        s["encoder"] = _encoder_stack_specs(cfg)
        s["enc_final_norm"] = L.norm_spec(cfg.d_model)
    return s


# ---------------------------------------------------------------------------
# Prefill block application
# ---------------------------------------------------------------------------

def _ffn(p: Params, h, cfg: ModelConfig):
    """The block's FFN on ``h``: (out, the MoE aux loss or None)."""
    if "moe" in p:
        return moe.moe_ffn(p["moe"], h, cfg.moe)
    if "mlp" in p:
        return L.gelu_mlp(p["mlp"], h), None
    return L.swiglu_ffn(p["ffn"], h), None


def _cross_kv(p: Params, enc_out):
    """The cross-attention's keys and values from the encoder's output:
    (B, T, Kv, hd) each, no RoPE."""
    return (attn._project(enc_out, p["xattn"]["wk"]),
            attn._project(enc_out, p["xattn"]["wv"]))


def _cross_q(p: Params, x, cfg: ModelConfig):
    """The cross-attention's queries from the decoder's stream ``x``."""
    return attn._project(L.rms_norm(x, p["ln_x"], cfg.rms_norm_eps),
                         p["xattn"]["wq"])


def _apply_block(p: Params, x, cfg: ModelConfig, positions, enc_out=None,
                 *, causal: bool = True):
    """The block's output and its aux loss (None for a dense FFN or an
    xLSTM block).  A mamba block (``"mamba"`` in ``p``) mixes with
    ``ssm.mamba_mixer``, an xLSTM block (``"mlstm"`` or ``"slstm"``) with
    its mixer and nothing after it, the others with attention.  A
    decoder block with ``"xattn"`` then attends over ``enc_out`` (B, T,
    d), every frame visible."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    if "mlstm" in p:
        return x + xlstm.mlstm_mixer(p["mlstm"], h, cfg), None
    if "slstm" in p:
        return x + xlstm.slstm_mixer(p["slstm"], h, cfg), None
    if "mamba" in p:
        x = x + ssm.mamba_mixer(p["mamba"], h, cfg)
    else:
        q, k, v = attn.qkv_project(p["attn"], h, positions, cfg.rope_theta)
        x = x + attn.out_project(p["attn"],
                                 attn.attention(q, k, v, causal=causal))
    if enc_out is not None and "xattn" in p:
        k, v = _cross_kv(p, enc_out)
        x = x + attn.out_project(
            p["xattn"], attn.attention(_cross_q(p, x, cfg), k, v,
                                       causal=False))
    h = L.rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    y, aux = _ffn(p, h, cfg)
    return x + y, aux


def _layer(stack: Params, r: int) -> Params:
    """Layer ``r`` of the stacked ``[R, ...]`` leaves (views)."""
    return pt.tmap(lambda a: a[r], stack)


#: Remat policies of ``forward_hidden`` / ``loss_fn`` (module docstring).
REMAT_POLICIES = ("none", "full", "dots")
#: What the ``"dots"`` policy keeps: the matrix products without a batch
#: dim (a (B, S, d) @ (d, n) projection folds to one ``mm``).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _remat(fn, policy: str):
    """``fn`` under the remat ``policy`` (module docstring)."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, list(_DOTS)))
    raise ValueError(f"remat policy {policy!r}; pick one of "
                     f"{REMAT_POLICIES}")


def _add_aux(total, a):
    return a if total is None else (total if a is None else total + a)


def _run_stack(stack: Params, x, cfg: ModelConfig, positions, enc_out=None,
               *, causal: bool = True, remat: str = "none"):
    """The layer stack's output and the sum of its blocks' aux losses
    over the layers (None where every block is dense).  ``enc_out`` is
    an input of each (checkpointed) layer, not recomputed inside it."""
    repeats = cfg.num_layers // len(cfg.pattern)
    aux = None
    for r in range(repeats):
        layer = _layer(stack, r)

        def body(y, enc, layer=layer):
            layer_aux = None
            for i, _ in enumerate(cfg.pattern):
                y, a = _apply_block(layer[f"pos_{i}"], y, cfg, positions,
                                    enc, causal=causal)
                layer_aux = _add_aux(layer_aux, a)
            return y, layer_aux

        x, a = _remat(body, remat)(x, enc_out)
        aux = _add_aux(aux, a)
    return x, aux


def _run_encoder(params: Params, frames, cfg: ModelConfig,
                 remat: str = "none"):
    """The encoder's output (B, T, d) of ``frames`` (B, T, d): its
    ``attn`` blocks, non-causal with RoPE over the frame positions, each
    layer under ``remat``, then ``enc_final_norm``."""
    positions = torch.arange(frames.shape[1], device=frames.device)
    x = frames
    for r in range(cfg.num_encoder_layers):
        layer = _layer(params["encoder"], r)["pos_0"]

        def body(y, layer=layer):
            return _apply_block(layer, y, cfg, positions, causal=False)[0]

        x = _remat(body, remat)(x)
    return L.rms_norm(x, params["enc_final_norm"], cfg.rms_norm_eps)


def _forward_hidden_aux(params: Params, batch: Dict[str, Any],
                        cfg: ModelConfig, remat: str = "none"):
    """Final-norm hidden states (B, S, d) of ``batch["tokens"]`` (B, S),
    each layer under the ``remat`` policy, and the MoE blocks' aux loss
    summed over the layers (None for a dense arch, whose aux is 0).  An
    encoder-decoder runs its encoder on ``batch["frames"]`` (B, T, d)
    first and its decoder attends over the output."""
    _check_ported(cfg)
    enc_out = (_run_encoder(params, batch["frames"], cfg, remat)
               if cfg.encoder_decoder else None)
    x = L.embed(params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _run_stack(params["stack"], x, cfg, positions, enc_out,
                        causal=True, remat=remat)
    return L.rms_norm(x, params["final_norm"], cfg.rms_norm_eps), aux


def forward_hidden(params: Params, batch: Dict[str, Any], cfg: ModelConfig,
                   remat: str = "none"):
    """Final-norm hidden states (B, S, d) of ``batch["tokens"]`` (B, S)
    (and ``batch["frames"]`` for an encoder-decoder), each layer under
    the ``remat`` policy."""
    return _forward_hidden_aux(params, batch, cfg, remat)[0]


def loss_fn(params: Params, batch: Dict[str, Any], cfg: ModelConfig,
            remat: str = "full"):
    """Mean token cross-entropy of ``batch`` ({"tokens", "labels"}, both
    (B, S), and ``"frames"`` (B, T, d) for an encoder-decoder; label -1
    = ignore) through the tied embedding or the head,
    chunked over the sequence (each chunk checkpointed unless ``remat``
    is ``"none"``), plus the MoE blocks' load-balance loss.  The dense
    blocks add none (the reference's ``aux`` is 0 for them)."""
    hidden, aux = _forward_hidden_aux(params, batch, cfg, remat)
    if cfg.tie_embeddings:
        ce = L.chunked_softmax_xent(
            hidden, params["embed"]["embedding"], batch["labels"],
            transpose=True, remat=remat != "none")
    else:
        ce = L.chunked_softmax_xent(hidden, params["head"]["w"],
                                    batch["labels"], transpose=False,
                                    remat=remat != "none")
    return ce if aux is None else ce + aux


def _logits(params: Params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.head(params["head"], x)


@torch.inference_mode()
def prefill(params: Params, batch: Dict[str, Any], cfg: ModelConfig):
    """Full-sequence forward returning the last position's logits
    (B, 1, V).  (As in the reference, serving builds the KV cache
    through the decode path; prefill scores the prompt.  An
    encoder-decoder's batch is the reference's serving batch: S frames
    for the encoder, one BOS token for the decoder.)"""
    hidden = forward_hidden(params, batch, cfg)
    return _logits(params, hidden[:, -1:], cfg)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def _cache_block_specs(kind: str, cfg: ModelConfig, batch: int,
                       cache_len: int, enc_len: int = 0) -> dict:
    H = cfg.num_heads
    if kind == cb.MLSTM:
        dk = xlstm.mlstm_dims(cfg)[1]
        return {"C": ParamSpec((batch, H, dk, dk),
                               ("batch", None, None, None), init="zeros"),
                "n": ParamSpec((batch, H, dk), ("batch", None, None),
                               init="zeros"),
                "m": ParamSpec((batch, H), ("batch", None), init="zeros")}
    if kind == cb.SLSTM:
        dh = cfg.d_model // H
        return {name: ParamSpec((batch, H, dh), ("batch", None, None),
                                init="zeros")
                for name in ("c", "n", "m", "h")}
    if kind not in _ATTN_KINDS:
        di, _, N = ssm.mamba_dims(cfg)
        return {"h": ParamSpec((batch, di, N),
                               ("batch", "ssm_inner", "ssm_state"),
                               init="zeros"),
                "conv": ParamSpec((batch, cfg.ssm_conv_dim - 1, di),
                                  ("batch", None, "ssm_inner"),
                                  init="zeros")}
    hd = cfg.resolved_head_dim
    kv = ("batch", "seq", "kv_heads", "head_dim")
    shape = (batch, cache_len, cfg.num_kv_heads, hd)
    c = {"k": ParamSpec(shape, kv, init="zeros"),
         "v": ParamSpec(shape, kv, init="zeros")}
    if cfg.encoder_decoder:
        cross = (batch, enc_len, cfg.num_kv_heads, hd)
        c["ck"] = ParamSpec(cross, kv, init="zeros")
        c["cv"] = ParamSpec(cross, kv, init="zeros")
    return c


def decode_cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                       enc_len: int = 0) -> dict:
    """Cache ParamSpec tree, stacked over the repeats like the params;
    an encoder-decoder's attention blocks also hold ``ck`` / ``cv`` of
    ``enc_len`` rows."""
    _check_ported(cfg)
    repeats = cfg.num_layers // len(cfg.pattern)
    return {f"pos_{p}": pt.tmap(lambda s: _stack(s, repeats),
                                _cache_block_specs(kind, cfg, batch,
                                                   cache_len, enc_len))
            for p, kind in enumerate(cfg.pattern)}


@torch.inference_mode()
def fill_cross_cache(params: Params, frames, cache: Params,
                     cfg: ModelConfig) -> Params:
    """Writes every decoder layer's ``ck`` / ``cv`` (R, B, T, Kv, hd) in
    ``cache`` from the encoder's output of ``frames`` (B, T, d): the keys
    and values the teacher-forced forward's cross-attention takes.
    Returns ``cache``.  (The reference writes no code for it: its serve
    loop decodes over zero ``ck`` / ``cv``.)"""
    enc_out = _run_encoder(params, frames, cfg)
    for name, c in cache.items():
        stack = params["stack"][name]
        for r in range(c["ck"].shape[0]):
            c["ck"][r], c["cv"][r] = _cross_kv(_layer(stack, r), enc_out)
    return cache


def effective_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Sliding-window archs cap decode KV memory at the window size."""
    if cfg.sliding_window and seq_len > cfg.sliding_window:
        return cfg.sliding_window
    return seq_len


# ---------------------------------------------------------------------------
# Decode-step block application
# ---------------------------------------------------------------------------

def _apply_block_decode(p: Params, x, cache: Params, cfg: ModelConfig,
                        t: int):
    """x: (B,1,d); t: absolute position.  Writes the token's K/V (an
    attention block), the SSM state and conv window (a mamba block) or
    the recurrent state (an xLSTM block) into ``cache`` in place and
    returns the block's output.  An encoder-decoder's block then attends
    over every row of the cache's ``ck`` / ``cv``."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    if "mlstm" in p:
        return x + xlstm.mlstm_decode_step(p["mlstm"], h, cache, cfg)[0]
    if "slstm" in p:
        return x + xlstm.slstm_decode_step(p["slstm"], h, cache, cfg)[0]
    if "mamba" in p:
        x = x + ssm.mamba_decode_step(p["mamba"], h, cache, cfg)[0]
    else:
        pos = torch.full((x.shape[0], 1), t, device=x.device)
        q, k, v = attn.qkv_project(p["attn"], h, pos, cfg.rope_theta)
        kc, vc = attn.update_cache(cache["k"], cache["v"], k, v, t)
        # ring buffer: valid length saturates at capacity
        o = attn.cached_attention(q, kc, vc,
                                  cache_len=min(t + 1, kc.shape[1]))
        x = x + attn.out_project(p["attn"], o)
    if "xattn" in p:
        o = attn.cached_attention(_cross_q(p, x, cfg), cache["ck"],
                                  cache["cv"],
                                  cache_len=cache["ck"].shape[1])
        x = x + attn.out_project(p["xattn"], o)
    h = L.rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    return x + _ffn(p, h, cfg)[0]


@torch.inference_mode()
def decode_step(params: Params, batch: Dict[str, Any], cache: Params,
                cfg: ModelConfig):
    """One-token decode.

    ``batch``: {"tokens": (B,1) int, "t": the absolute position (an int
    or a 0-d tensor)}.  Returns (logits (B,1,V), cache): the cache's
    ring slot ``t % cache_len`` of every attention layer, the state and
    conv window of every mamba layer and the states of every xLSTM layer
    are written in place (the reference returns an updated copy).
    """
    _check_ported(cfg)
    x = L.embed(params["embed"], batch["tokens"])
    t = int(batch["t"])
    repeats = cfg.num_layers // len(cfg.pattern)
    for r in range(repeats):
        layer, layer_cache = _layer(params["stack"], r), _layer(cache, r)
        for i, _ in enumerate(cfg.pattern):
            x = _apply_block_decode(layer[f"pos_{i}"], x,
                                    layer_cache[f"pos_{i}"], cfg, t)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(params, x, cfg), cache


__all__ = [
    "model_specs", "prefill", "decode_step", "decode_cache_specs",
    "effective_cache_len", "fill_cross_cache", "forward_hidden", "loss_fn",
]
