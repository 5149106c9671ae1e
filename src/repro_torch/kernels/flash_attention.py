"""Blockwise online-softmax attention (K7) and its wrapper.

Counterpart of ``flash_attention_3d`` in ``repro/kernels/flash_attention.py``:
``q`` (BH, S, hd) against ``k``/``v`` (BH, T, hd), causal or not, with
``causal_period`` for GQA-folded query rows (row ``i`` sits at sequence
position ``i % causal_period``).  On the card it launches
``csrc/flash_attention.cu``; for tensors on the CPU it takes the plain
version ``kernels/ref.flash_attention_3d_ref``.  Unlike the TPU kernel it
takes any S and T (the CUDA kernel masks the tails), for head dims 32, 64
and 128 in float32 (three-pass TF32 on the tensor cores) or bfloat16
(wgmma from TMA-filled shared memory).  The model path reaches it through
``models/attention.flash_gqa``, which folds the query heads in the model's
own order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import F, I, P

#: Head dims the kernel is built for (a template parameter of the source).
HEAD_DIMS = (32, 64, 128)
#: A launch's grid has bh on x and one row block per 128 rows on y.
ROW_BLOCK = 128
MAX_ROWS = 65535 * ROW_BLOCK

_SIGNATURES = {fn: (P, P, P, P, I, I, I, I, I, I, F, P)
               for fn in ("flash_attention_f32", "flash_attention_bf16")}
_FN = {torch.float32: "flash_attention_f32",
       torch.bfloat16: "flash_attention_bf16"}


def _check(q, k, v, causal_period: int) -> None:
    what = "flash_attention_3d"
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{what}: q, k and v must be 3-D (BH, S|T, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"{what}: k and v must be (BH, T, hd) with q's BH "
                         f"and hd, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {q.shape[2]}; the kernel takes "
                         f"{HEAD_DIMS}")
    if k.shape[1] < 1:
        raise ValueError(f"{what}: no keys (T = 0)")
    if q.shape[1] > MAX_ROWS:
        raise ValueError(f"{what}: S = {q.shape[1]} > {MAX_ROWS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _FN:
            raise TypeError(f"{what}: {name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {q.device}; the kernel runs "
                         f"on CUDA, the plain version on CPU")
    if causal_period < 0:
        raise ValueError(f"{what}: causal_period {causal_period} < 0")


def _aligned(t):
    """``t`` contiguous with a 16-byte aligned start (the kernel's vector
    loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_3d(q, k, v, *, causal: bool = True,
                       causal_period: int = 0):
    """K7: ``softmax(q k^T * hd^-0.5, masked) v`` per bh, accumulated in
    float32, output in ``q``'s dtype.  ``q``: (BH, S, hd); ``k``, ``v``:
    (BH, T, hd).  Under ``causal``, key ``j`` is visible to row ``i`` iff
    ``j <= i % causal_period`` (``j <= i`` for ``causal_period=0``)."""
    _check(q, k, v, causal_period)
    if q.device.type == "cpu":
        return ref.flash_attention_3d_ref(q, k, v, causal=causal,
                                          causal_period=causal_period)
    bh, s, hd = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if bh == 0 or s == 0:
        return out
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    lib = build.library("flash_attention", _SIGNATURES)
    rc = getattr(lib, _FN[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s,
        k.shape[1], hd, int(causal), causal_period, hd ** -0.5,
        build.stream())
    build.check_launch(rc, "flash_attention_3d")
    build.launch_counts["flash_attention"] += 1
    return out
