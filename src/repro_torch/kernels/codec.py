"""Fused codec decode + aggregate kernels (K5, K6) and their wrappers.

    K5  agg = sum_k mask_k * scale_k * vals_k / max(sum_k mask_k, 1)
    K6  part = sum_k mask_k * scale_k * vals_k

Counterparts of ``codec_aggregate`` and ``codec_aggregate_partial`` in
``repro/kernels/codec.py``: one launch turns the stacked
``(K, rows, 128)`` encoded cohort into the ``(rows, 128)`` aggregate,
reading each active client's slab once.  K5 is the single-process
round's whole aggregate; K6 is one shard's partial under the client
mesh (``core/sharding.py``), whose partials and mask counts the ranks
sum and divide once.  On the card each launches ``csrc/codec.cu``; for
tensors on the CPU they take the plain versions in ``kernels/ref.py``,
to which the kernels are bitwise equal.  Linear post-transforms of a
codec (int8's inverse rotation) apply to the aggregate after the launch.
A launch's host path is short: one check of a few attribute reads, the C
entry point resolved once, one allocation, the raw stream handle.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import LL, I, P
from repro_torch.kernels.dane_update import LANES

#: Clients one launch takes (the kernel stages their weights in shared
#: memory).
MAX_CLIENTS = 1024

_SIGNATURES = {"codec_aggregate_f32": (P, P, P, P, I, LL, P),
               "codec_aggregate_partial_f32": (P, P, P, P, I, LL, P)}
F32 = torch.float32


def _first(bad, vals, scales, mask):
    """The name and tensor of the first operand for which ``bad`` holds
    (to say which one broke a rule)."""
    return next((n, t) for n, t in (("vals", vals), ("scales", scales),
                                    ("mask", mask)) if bad(t))


def _check(what: str, vals, scales, mask) -> bool:
    """Raise unless ``vals``, ``scales`` and ``mask`` are operands the
    kernels take; return whether they lie on the card.  One pass of a few
    attribute reads, the launch path's whole check: a message is built
    only when its rule fails."""
    if vals.dim() != 3 or vals.shape[2] != LANES:
        raise ValueError(f"{what}: vals must be (K, rows, {LANES}), got "
                         f"{tuple(vals.shape)}")
    k = vals.shape[0]
    if not 1 <= k <= MAX_CLIENTS:
        raise ValueError(f"{what}: {k} clients; one launch takes 1 to "
                         f"{MAX_CLIENTS}")
    if not vals.dtype == scales.dtype == mask.dtype == F32:
        name, t = _first(lambda t: t.dtype != F32, vals, scales, mask)
        raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
    if not vals.device == scales.device == mask.device:
        name, t = _first(lambda t: t.device != vals.device, vals, scales,
                         mask)
        raise ValueError(f"{what}: {name} is on {t.device}, vals on "
                         f"{vals.device}")
    if scales.shape != (k,) or mask.shape != (k,):
        name, t = _first(lambda t: t is not vals and t.shape != (k,), vals,
                         scales, mask)
        raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != "
                         f"({k},)")
    if not (vals.is_cuda or vals.is_cpu):
        raise ValueError(f"{what}: tensors on {vals.device}; the kernel "
                         f"runs on CUDA, the plain version on CPU")
    return vals.is_cuda


#: Each C entry point, resolved at its first launch.
_FNS = {}


def _launch(fn: str, what: str, vals, scales, mask):
    f = _FNS.get(fn)
    if f is None:
        f = _FNS[fn] = getattr(build.library("codec", _SIGNATURES), fn)
    if not vals.is_contiguous():
        vals = vals.contiguous()
    if not scales.is_contiguous():
        scales = scales.contiguous()
    if not mask.is_contiguous():
        mask = mask.contiguous()
    out = vals.new_empty(vals.shape[1:])
    rc = f(vals.data_ptr(), scales.data_ptr(), mask.data_ptr(),
           out.data_ptr(), vals.shape[0], vals.shape[1] * LANES,
           build.stream())
    build.check_launch(rc, what)
    build.launch_counts[what] += 1
    return out


def codec_aggregate(vals, scales, mask):
    """K5: the ``(rows, 128)`` dequantized masked mean of the
    ``(K, rows, 128)`` float32 cohort ``vals``, with ``(K,)`` float32
    per-client ``scales`` and 0/1 ``mask`` (inactive clients add
    neither signal nor count; an all-inactive cohort gives zeros)."""
    if not _check("codec_aggregate", vals, scales, mask):
        return ref.codec_aggregate_ref(vals, scales, mask)
    return _launch("codec_aggregate_f32", "codec_aggregate", vals, scales,
                   mask)


def codec_aggregate_partial(vals, scales, mask):
    """K6: the ``(rows, 128)`` dequantized masked SUM of one shard's
    ``(K/D, rows, 128)`` float32 cohort slab (no division by the count),
    with K5's operands and checks.  An all-inactive shard gives +0.0."""
    if not _check("codec_aggregate_partial", vals, scales, mask):
        return ref.codec_aggregate_partial_ref(vals, scales, mask)
    return _launch("codec_aggregate_partial_f32", "codec_aggregate_partial",
                   vals, scales, mask)
