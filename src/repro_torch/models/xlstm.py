"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory with recurrent gate connections), both with exponential
gating and the paper's max-based stabiliser state.

Counterpart of ``repro/models/xlstm.py``, with its parameter trees
(``mlstm_specs``, ``slstm_specs``), projections, steps and states:

- :func:`mlstm_scan`, :func:`slstm_scan`: the recurrences of the prefill
  and of training, the autograd Functions of ``kernels/xlstm_scan.py`` on
  every device -- on the card the hand-written kernels K9 and K10, and
  under grad their backward K9-bwd and K10-bwd; on the CPU their plain
  versions (``kernels/ref.mlstm_scan_ref`` / ``slstm_scan_ref``,
  ``ssm.chunked_scan`` of the reference's step from its initial state,
  ``m = -1e30``, and the explicit backward walks ``mlstm_scan_bwd_ref`` /
  ``slstm_scan_bwd_ref``).  The mixers look them up at call time, so a
  comparison run can swap the plain scans in on the card (autograd then
  differentiates the plain step loop).
- :func:`mlstm_decode_step`, :func:`slstm_decode_step`: one step of the
  same recurrence on the decode cache, plain PyTorch on every device; they
  write the new state into the cache in place (the reference returns new
  ones).  The cache starts from zeros, ``m`` included (the reference's
  cache specs say ``init="zeros"``), while the prefill starts ``m`` at
  -1e30: the two paths agree only once their ``m`` coincide, as in the
  reference, and neither is changed to meet the other.

The reference's ``constrain`` calls (sharding hints) have no counterpart
here.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ref, xlstm_scan
from repro_torch.models.param import ParamSpec
from repro_torch.models.ssm import SCAN_CHUNK

F32 = torch.float32
_logsigmoid = ref.logsigmoid


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    d_inner = 2 * cfg.d_model
    return d_inner, d_inner // cfg.num_heads


def mlstm_specs(cfg: ModelConfig) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    d_inner, _ = mlstm_dims(cfg)
    return {
        "w_up": ParamSpec((d, 2 * d_inner), ("d_model", "ssm_inner")),
        "w_q": ParamSpec((d_inner, d_inner), ("ssm_inner", None)),
        "w_k": ParamSpec((d_inner, d_inner), ("ssm_inner", None)),
        "w_v": ParamSpec((d_inner, d_inner), ("ssm_inner", None)),
        "w_if": ParamSpec((d, 2 * H), ("d_model", None), scale=0.02),
        "b_if": ParamSpec((2 * H,), (None,), init="zeros"),
        "w_down": ParamSpec((d_inner, d), ("ssm_inner", "d_model")),
    }


_mlstm_step = ref.mlstm_step


def _mlstm_inputs(params, x, cfg: ModelConfig):
    """x (B, S, d) -> q, k, v (B, S, H, dk) f32, log_i, log_f (B, S, H)
    f32, the gate z (B, S, d_inner) and dk."""
    B, S, _ = x.shape
    H = cfg.num_heads
    d_inner, dk = mlstm_dims(cfg)
    up = x @ params["w_up"]
    xm, z = up[..., :d_inner], up[..., d_inner:]
    heads = lambda a: a.reshape(B, S, H, dk).to(F32)
    q = heads(xm @ params["w_q"])
    k = heads(xm @ params["w_k"])
    v = heads(xm @ params["w_v"])
    gates = (x @ params["w_if"] + params["b_if"]).to(F32)
    log_i, log_f = gates[..., :H], _logsigmoid(gates[..., H:])
    return q, k, v, log_i, log_f, z, dk


def mlstm_init_state(cfg: ModelConfig, batch: int, device=None):
    """The prefill's initial state (the reference's): C, n zeros, m at
    -1e30, f32, on ``device`` (the card unless ``"cpu"``)."""
    H = cfg.num_heads
    _, dk = mlstm_dims(cfg)
    device = resolve_device(device)
    return {"C": torch.zeros((batch, H, dk, dk), dtype=F32, device=device),
            "n": torch.zeros((batch, H, dk), dtype=F32, device=device),
            "m": torch.full((batch, H), ref.M_START, dtype=F32,
                            device=device)}


def mlstm_scan(q, k, v, log_i, log_f, chunk: int = SCAN_CHUNK):
    """The mLSTM scan of the prefill and of training: K9 (with K9-bwd
    under grad) on the card; on the CPU ``ref.mlstm_scan_ref``,
    ``chunked_scan`` of ``_mlstm_step`` from ``mlstm_init_state``, and its
    explicit backward.  (B, S, H, dk) f32."""
    return xlstm_scan.mlstm_scan(q, k, v, log_i, log_f, chunk)


def mlstm_mixer(params, x, cfg: ModelConfig, chunk: int = SCAN_CHUNK):
    """Prefill forward.  x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    q, k, v, log_i, log_f, z, _ = _mlstm_inputs(params, x, cfg)
    h = mlstm_scan(q, k, v, log_i, log_f, chunk)
    h = h.reshape(B, S, -1).to(x.dtype) * F.silu(z)
    return h @ params["w_down"]


def mlstm_decode_step(params, x, state, cfg: ModelConfig):
    """x: (B, 1, d); state: {C, n, m} -> (out (B, 1, d), state): one step
    of the recurrence, the new C, n and m written into ``state`` in
    place."""
    q, k, v, log_i, log_f, z, dk = _mlstm_inputs(params, x, cfg)
    (C, n, m), h = _mlstm_step(dk)(
        (state["C"], state["n"], state["m"]),
        (q[:, 0], k[:, 0], v[:, 0], log_i[:, 0], log_f[:, 0]))
    h = h.reshape(x.shape[0], 1, -1).to(x.dtype)
    out = (h * F.silu(z)) @ params["w_down"]
    for key, new in (("C", C), ("n", n), ("m", m)):
        state[key].copy_(new)
    return out, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ModelConfig) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    return {
        "w_x": ParamSpec((d, 4 * d), ("d_model", "ssm_inner")),
        "b_x": ParamSpec((4 * d,), ("ssm_inner",), init="zeros"),
        # per-head recurrent matrices (block-diagonal structure)
        "r_z": ParamSpec((H, dh, dh), (None, None, None), scale=0.02),
        "r_i": ParamSpec((H, dh, dh), (None, None, None), scale=0.02),
        "r_f": ParamSpec((H, dh, dh), (None, None, None), scale=0.02),
        "r_o": ParamSpec((H, dh, dh), (None, None, None), scale=0.02),
        "w_out": ParamSpec((d, d), ("ssm_inner", "d_model")),
    }


_RECURRENT = ("r_z", "r_i", "r_f", "r_o")


def _slstm_step(params, H: int):
    """The reference's step on ``params``' recurrent matrices (``H``, the
    reference's argument, is read off their shape)."""
    return ref.slstm_step(*(params[key] for key in _RECURRENT))


def slstm_init_state(cfg: ModelConfig, batch: int, device=None):
    """The prefill's initial state (the reference's): c, n, h zeros, m at
    -1e30, each (B, H, dh) f32, on ``device`` (the card unless
    ``"cpu"``)."""
    H = cfg.num_heads
    shape = (batch, H, cfg.d_model // H)
    device = resolve_device(device)
    zeros = lambda: torch.zeros(shape, dtype=F32, device=device)
    return {"c": zeros(), "n": zeros(),
            "m": torch.full(shape, ref.M_START, dtype=F32, device=device),
            "h": zeros()}


def _slstm_inputs(params, x, cfg: ModelConfig):
    """x (B, S, d) -> zx, ix, fx, ox, each (B, S, H, dh) f32."""
    B, S, d = x.shape
    H = cfg.num_heads
    g = (x @ params["w_x"] + params["b_x"]).to(F32)
    g = g.reshape(B, S, 4, H, d // H)
    return g[:, :, 0], g[:, :, 1], g[:, :, 2], g[:, :, 3]


def slstm_scan(zx, ix, fx, ox, r_z, r_i, r_f, r_o, chunk: int = SCAN_CHUNK):
    """The sLSTM scan of the prefill and of training: K10 (with K10-bwd
    under grad) on the card; on the CPU ``ref.slstm_scan_ref``,
    ``chunked_scan`` of ``_slstm_step`` from ``slstm_init_state``, and its
    explicit backward.  (B, S, H, dh) f32.  ``chunk``, the reference's,
    changes no value here: K10 keeps every step's state."""
    return xlstm_scan.slstm_scan(zx, ix, fx, ox, r_z, r_i, r_f, r_o)


def slstm_mixer(params, x, cfg: ModelConfig, chunk: int = SCAN_CHUNK):
    """Prefill forward.  x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    h = slstm_scan(*_slstm_inputs(params, x, cfg),
                   *(params[key] for key in _RECURRENT), chunk)
    return h.reshape(B, S, d).to(x.dtype) @ params["w_out"]


def slstm_decode_step(params, x, state, cfg: ModelConfig):
    """x: (B, 1, d); state: {c, n, m, h} -> (out (B, 1, d), state): one
    step of the recurrence, the new c, n, m and h written into ``state``
    in place."""
    B = x.shape[0]
    zx, ix, fx, ox = _slstm_inputs(params, x, cfg)
    (c, n, m, h), h_out = _slstm_step(params, cfg.num_heads)(
        (state["c"], state["n"], state["m"], state["h"]),
        (zx[:, 0], ix[:, 0], fx[:, 0], ox[:, 0]))
    out = h_out.reshape(B, 1, -1).to(x.dtype) @ params["w_out"]
    for key, new in (("c", c), ("n", n), ("m", m), ("h", h)):
        state[key].copy_(new)
    return out, state
