"""Fused codec decode + aggregate kernel (K5) and its wrapper.

    agg = sum_k mask_k * scale_k * vals_k / max(sum_k mask_k, 1)

Counterpart of ``codec_aggregate`` in ``repro/kernels/codec.py``: one
launch turns the stacked ``(K, rows, 128)`` encoded cohort into the
``(rows, 128)`` aggregate, reading each active client's slab once.  On
the card it launches ``csrc/codec.cu``; for tensors on the CPU it takes
the plain version in ``kernels/ref.py``, to which the kernel is bitwise
equal.  Linear post-transforms of a codec (int8's inverse rotation)
apply to the aggregate after this launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import LL, I, P
from repro_torch.kernels.dane_update import LANES

#: Clients one launch takes (the kernel stages their weights in shared
#: memory).
MAX_CLIENTS = 1024

_SIGNATURES = {"codec_aggregate_f32": (P, P, P, P, I, LL, P)}
F32 = torch.float32


def codec_aggregate(vals, scales, mask):
    """K5: the ``(rows, 128)`` dequantized masked mean of the
    ``(K, rows, 128)`` float32 cohort ``vals``, with ``(K,)`` float32
    per-client ``scales`` and 0/1 ``mask`` (inactive clients add
    neither signal nor count; an all-inactive cohort gives zeros)."""
    what = "codec_aggregate"
    if vals.dim() != 3 or vals.shape[2] != LANES:
        raise ValueError(f"{what}: vals must be (K, rows, {LANES}), got "
                         f"{tuple(vals.shape)}")
    k = vals.shape[0]
    if not 1 <= k <= MAX_CLIENTS:
        raise ValueError(f"{what}: {k} clients; one launch takes 1 to "
                         f"{MAX_CLIENTS}")
    for name, t in (("vals", vals), ("scales", scales), ("mask", mask)):
        if t.dtype != F32:
            raise TypeError(f"{what}: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != vals.device:
            raise ValueError(f"{what}: {name} is on {t.device}, vals on "
                             f"{vals.device}")
    for name, t in (("scales", scales), ("mask", mask)):
        if t.shape != (k,):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != "
                             f"({k},)")
    if vals.device.type == "cpu":
        return ref.codec_aggregate_ref(vals, scales, mask)
    if vals.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {vals.device}; the kernel "
                         f"runs on CUDA, the plain version on CPU")
    vals, scales, mask = (t.contiguous() for t in (vals, scales, mask))
    lib = build.library("codec", _SIGNATURES)
    out = torch.empty(vals.shape[1:], dtype=F32, device=vals.device)
    rc = lib.codec_aggregate_f32(
        vals.data_ptr(), scales.data_ptr(), mask.data_ptr(), out.data_ptr(),
        k, vals.shape[1] * LANES, build.stream())
    build.check_launch(rc, what)
    build.launch_counts["codec_aggregate"] += 1
    return out
