"""The built-in wire codecs: none / int8 / topk / dp_gauss.

Counterpart of ``repro/core/codecs/builtin.py``, in the reference's
order of operations; each encoder reads its randomness from the round's
:class:`~repro_torch.core.codecs.spec.CodecDraws` instead of a
``jax.random`` key.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.codecs.spec import (DENSE_BYTES, CodecSpec,
                                          register_codec, topk_keep)
from repro_torch.kernels.flatpack import LANES

F32 = torch.float32

# -- none: the identity wire format -----------------------------------------

NONE = register_codec(CodecSpec(
    name="none",
    summary="dense float32 pytrees -- the identity wire format (structural "
            "no-op: every path keeps its exact pre-codec program)",
))


# -- int8: stochastic uniform quantization + random rotation ----------------
#
# Suresh et al. (1611.00429): a shared random rotation H.D -- Rademacher
# signs, then a 128-point Hadamard transform along the lanes of the flat
# pack -- flattens the coordinates before a per-client uniform
# quantization with stochastic rounding floor(y/s + u), which is
# unbiased.  The rotation is a plain f32 product (TF32 is off).

def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1.0]], np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return (h / np.sqrt(n)).astype(np.float32)


_H128 = torch.from_numpy(_hadamard(LANES))
_H_ON: Dict[torch.device, torch.Tensor] = {}


def _h128(device) -> torch.Tensor:
    h = _H_ON.get(device)
    if h is None:
        h = _H_ON[device] = _H128.to(device)
    return h


def _rotate(draws, x):
    """Shared orthonormal preconditioner: x -> (x * D) @ H, per row."""
    return (x * draws.signs) @ _h128(x.device)


def _derotate(draws, x):
    """Inverse rotation (H is symmetric orthonormal: H^-1 = H)."""
    return (x @ _h128(x.device)) * draws.signs


def _int8_encode(cfg, draws, idx, flat, ef):
    del ef
    levels = float(2 ** (cfg.bits - 1) - 1)
    y = _rotate(draws, flat)
    scale = torch.clamp(torch.max(torch.abs(y)) / levels, min=1e-12)
    q = torch.clamp(torch.floor(y / scale + draws.u[idx]), -levels, levels)
    return q, scale, None


def _int8_bytes(cfg, n: int) -> float:
    # one b-bit code per coordinate + the float32 scale
    return n * cfg.bits / 8.0 + DENSE_BYTES


INT8 = register_codec(CodecSpec(
    name="int8",
    summary="stochastic uniform quantization at cfg.bits (default 8) with "
            "shared random-rotation preconditioning (1611.00429)",
    encode=_int8_encode,
    post_decode=lambda cfg, draws, agg: _derotate(draws, agg),
    uplink_bytes=_int8_bytes,
    uses_rng=True,
))


# -- topk: magnitude sparsification with persistent error feedback ----------
#
# The client sends the ceil(topk_frac * n) largest-magnitude coordinates
# of (delta + residual), rounded through float16 (the wire format the
# byte count assumes), and banks the rest in its error feedback
# (1809.07599), so transmitted + residual telescopes to the exact signal.
# Ties at the threshold may keep a few extra coordinates, as in the
# reference; zero padding never beats a positive threshold.

def _topk_encode(cfg, draws, idx, flat, ef):
    del draws, idx
    x = flat + ef
    k = topk_keep(cfg, x.numel())
    thresh = torch.topk(torch.abs(x).reshape(-1), k).values[-1]
    keep = (torch.abs(x) >= torch.clamp(thresh, min=1e-30)).to(F32)
    vals = (x * keep).to(torch.float16).to(F32)
    return vals, x.new_ones(()), x - vals


def _topk_bytes(cfg, n: int) -> float:
    # (fp16 value + uint16 delta-index) per kept coordinate + the count
    return topk_keep(cfg, n) * 4.0 + DENSE_BYTES


TOPK = register_codec(CodecSpec(
    name="topk",
    summary="top-k magnitude sparsification (cfg.topk_frac) with "
            "persistent per-client error feedback (1809.07599)",
    encode=_topk_encode,
    uplink_bytes=_topk_bytes,
    error_feedback=True,
))


# -- dp_gauss: l2 clip + server-side Gaussian noise -------------------------
#
# DP-FedAvg's Gaussian mechanism (1710.06963): each client clips its
# update to l2 norm cfg.clip_norm; the server adds noise of sigma =
# noise_mult * clip_norm / count to the aggregate.  Bytes stay dense.

def _dp_encode(cfg, draws, idx, flat, ef):
    del draws, idx, ef
    nrm = torch.sqrt(torch.sum(flat * flat))
    # tensor numerators: ``scalar / tensor`` would round twice; filled
    # on the device, not copied from the host, so a CUDA graph captures it
    clip = torch.full((), cfg.clip_norm, dtype=F32, device=flat.device)
    fac = torch.clamp(clip / torch.clamp(nrm, min=1e-12), max=1.0)
    return flat * fac, flat.new_ones(()), None


def _dp_post(cfg, draws, agg, count):
    sigma = torch.full((), cfg.noise_mult * cfg.clip_norm, dtype=F32,
                       device=agg.device) / count
    return agg + sigma * draws.noise


DP_GAUSS = register_codec(CodecSpec(
    name="dp_gauss",
    summary="per-client l2 clip (cfg.clip_norm) + server-side Gaussian "
            "noise (cfg.noise_mult) on the aggregate (1710.06963)",
    encode=_dp_encode,
    post_aggregate=_dp_post,
    uses_rng=True,
))
