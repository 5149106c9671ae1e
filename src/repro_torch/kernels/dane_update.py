"""Fused FedDANE local-update kernels (K1, K4) and their wrappers.

    w' = w - eta * (grad + (g_t - grad F_k(w0)) + mu * (w - w0))

Counterpart of ``repro/kernels/dane_update.py``.  On the card each call
launches the one kernel of ``csrc/dane_update.cu`` over a table of
segments (arrays): K1 (:func:`dane_update_flat`) is one masked segment
over the whole-tree flat pack, K4 (:func:`dane_update_2d`) one unmasked
segment, and :func:`dane_update_leaves` every leaf of a K-stacked tree,
masked, in one launch (the per_leaf solver step, counted as K4).  For
tensors on the CPU each takes its plain version in ``kernels/ref.py``.
eta and mu arrive as kernel arguments, so one build serves every round
and every algorithm.  A launch's host path is short: one check of a few
attribute reads, the C entry point resolved once, the table written into
a preallocated host buffer (not reentrant across threads) and passed by
pointer, the raw stream handle.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import LL, F, I, P

LANES = 128
#: The most elements of one device a masked launch takes (the kernel
#: finds an element's device with a 32-bit count; the pack as a whole is
#: indexed in 64 bits, so K devices of up to this many elements each,
#: over 2^31 in all, launch as one).
MAX_PER_DEV = 2 ** 31 - 1
#: Arrays one launch takes (the kernel's parameter table); longer lists
#: launch in chunks of this many.
MAX_SEGMENTS = 64

F32, BF16 = torch.float32, torch.bfloat16
_DTYPE_CODE = {F32: 0, BF16: 1}
_SIGNATURES = {"dane_update_segments": (P, I, P, LL, F, F, P)}
#: One segment as ``csrc/dane_update.cu``'s ``HostSegment``: the five
#: pointers w, g, c, a, out; the element count; the elements per device;
#: the dtype code; padding.
_SEG = struct.Struct("@5P2q2i")
_TABLE = ctypes.create_string_buffer(MAX_SEGMENTS * _SEG.size)
_TABLE_PTR = ctypes.addressof(_TABLE)
_FNS = {}
_NAMES = ("w", "grad", "g_corr", "anchor")


def _fail(what: str, ops):
    """Raise for the first rule ``ops`` (one array's operands) break."""
    w = ops[0]
    for n, t in zip(_NAMES, ops):
        if t.shape != w.shape or t.dtype != w.dtype or \
                t.device != w.device:
            raise ValueError(f"{what}: operands differ in shape, dtype or "
                             f"device ({n}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; w: {tuple(w.shape)} {w.dtype} on "
                             f"{w.device})")
    if w.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {w.dtype} not supported "
                        f"(supported: {tuple(_DTYPE_CODE)})")
    if not (w.is_cuda or w.is_cpu):
        raise ValueError(f"{what}: tensors on {w.device}; the kernel runs "
                         f"on CUDA, the plain version on CPU")
    n = next(n for n, t in zip(_NAMES, ops) if not t.is_contiguous())
    raise ValueError(f"{what}: {n} must be contiguous")


def _ok(w, g, c, a) -> bool:
    """Whether one array's operands are ones the kernel (on the card) or
    the plain version (on the CPU, any layout) takes: the cheap
    conjunction; :func:`_fail` says which rule broke."""
    return (w.shape == g.shape == c.shape == a.shape
            and w.dtype == g.dtype == c.dtype == a.dtype
            and w.dtype in _DTYPE_CODE
            and w.device == g.device == c.device == a.device
            and (w.is_cpu or (w.is_cuda and w.is_contiguous()
                              and g.is_contiguous() and c.is_contiguous()
                              and a.is_contiguous())))


def _check_2d(what: str, ops, dtypes) -> bool:
    """Raise unless ``ops`` are ``(rows, LANES)`` operands of a dtype in
    ``dtypes``; return whether they lie on the card."""
    w = ops[0]
    if not _ok(*ops):
        _fail(what, ops)
    if w.dim() != 2 or w.shape[1] != LANES:
        raise ValueError(f"{what}: operands must be (rows, {LANES}), "
                         f"got {tuple(w.shape)}")
    if w.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {w.dtype} not supported "
                        f"(supported: {dtypes})")
    return w.is_cuda


def _f32_on(mask, w):
    """``mask`` as float32 on ``w``'s device (no copy when it is)."""
    if mask.dtype == F32 and mask.device == w.device:
        return mask
    return mask.to(device=w.device, dtype=F32)


def _launch(what: str, arrays, mask, eta, mu) -> None:
    """Launch the step over ``arrays``, each ``(w, g, c, a, out,
    per_dev)`` on the card, in chunks of MAX_SEGMENTS, counting each
    launch under ``what``."""
    f = _FNS.get("segments")
    if f is None:
        f = _FNS["segments"] = build.library(
            "dane_update", _SIGNATURES).dane_update_segments
    mask_ptr = None if mask is None else mask.data_ptr()
    stride = 0 if mask is None else mask.stride(0)
    eta, mu, stream = float(eta), float(mu), build.stream()
    pack, size = _SEG.pack_into, _SEG.size
    for start in range(0, len(arrays), MAX_SEGMENTS):
        chunk = arrays[start:start + MAX_SEGMENTS]
        for j, (w, g, c, a, out, per_dev) in enumerate(chunk):
            pack(_TABLE, j * size, w.data_ptr(), g.data_ptr(), c.data_ptr(),
                 a.data_ptr(), out.data_ptr(), w.numel(), per_dev,
                 _DTYPE_CODE[w.dtype], 0)
        rc = f(_TABLE_PTR, len(chunk), mask_ptr, stride, eta, mu, stream)
        build.check_launch(rc, what)
        build.launch_counts[what] += 1


def dane_update_2d(w, grad, g_corr, anchor, eta, mu):
    """K4: the unmasked step on one leaf's ``(rows, LANES)`` view
    (float32 or bfloat16 storage, float32 arithmetic)."""
    ops = (w, grad, g_corr, anchor)
    if not _check_2d("dane_update_2d", ops, (F32, BF16)):
        return ref.dane_update_ref(w, grad, g_corr, anchor, eta=eta, mu=mu)
    out = torch.empty_like(w)
    _launch("dane_update_2d", [(*ops, out, w.numel())], None, eta, mu)
    return out


def dane_update_flat(w, grad, g_corr, anchor, eta, mu, mask,
                     rows_per_dev: int, *, out=None):
    """K1: ONE masked launch over a ``(K*rows_per_dev, LANES)`` f32 flat
    pack (``kernels.flatpack``); devices whose ``(K,)`` mask is not > 0
    keep ``w`` exactly.  ``out``: a contiguous buffer like ``w`` that no
    operand overlaps, written and returned (else a new one)."""
    ops = (w, grad, g_corr, anchor)
    on_card = _check_2d("dane_update_flat", ops, (F32,))
    total_rows = w.shape[0]
    if rows_per_dev <= 0 or total_rows % rows_per_dev:
        raise ValueError(f"dane_update_flat: {total_rows} rows are not a "
                         f"whole number of {rows_per_dev}-row devices")
    k = total_rows // rows_per_dev
    if rows_per_dev * LANES > MAX_PER_DEV:
        raise ValueError(f"dane_update_flat: a device's segment of "
                         f"{rows_per_dev * LANES:,} elements exceeds "
                         f"{MAX_PER_DEV:,}, the kernel's 32-bit "
                         f"per-device count")
    if out is not None and not (out.shape == w.shape and out.dtype == F32
                                and out.device == w.device
                                and out.is_contiguous()):
        raise ValueError(f"dane_update_flat: out must be a contiguous "
                         f"{tuple(w.shape)} float32 buffer on {w.device}")
    if mask.shape != (k,):
        raise ValueError(f"dane_update_flat: mask shape "
                         f"{tuple(mask.shape)} != ({k},)")
    if not on_card:
        new = ref.dane_update_flat_ref(w, grad, g_corr, anchor, eta, mu,
                                       mask, rows_per_dev)
        return new if out is None else out.copy_(new)
    if out is None:
        out = torch.empty_like(w)
    _launch("dane_update_flat", [(*ops, out, rows_per_dev * LANES)],
            _f32_on(mask, w), eta, mu)
    return out


def dane_update_leaves(w_leaves, g_leaves, c_leaves, a_leaves, eta, mu,
                       mask=None):
    """The step on every leaf of a tree in one launch (per chunk of
    MAX_SEGMENTS leaves, each counted as one K4 launch): float32 or
    bfloat16 leaves of any shape (contiguous on the card), float32
    arithmetic.  ``mask``: None, or a ``(K,)`` mask over the leaves' leading device
    axis; a device whose mask is not > 0 keeps ``w``'s bits.  Returns
    the new leaves, in order."""
    what = "dane_update_leaves"
    if not len(w_leaves) == len(g_leaves) == len(c_leaves) == len(a_leaves):
        raise ValueError(f"{what}: {len(w_leaves)}, {len(g_leaves)}, "
                         f"{len(c_leaves)} and {len(a_leaves)} leaves")
    if not w_leaves:
        return []
    w0 = w_leaves[0]
    for ops in zip(w_leaves, g_leaves, c_leaves, a_leaves):
        if not (_ok(*ops) and ops[0].device == w0.device):
            if _ok(*ops):
                raise ValueError(f"{what}: leaves on {ops[0].device} and "
                                 f"{w0.device}")
            _fail(what, ops)
    k = None
    if mask is not None:
        k = mask.shape[0] if mask.dim() == 1 else -1
        for w in w_leaves:
            if w.dim() == 0 or w.shape[0] != k:
                raise ValueError(f"{what}: mask shape {tuple(mask.shape)} "
                                 f"!= the leaves' leading axis "
                                 f"({tuple(w.shape)})")
    if not w0.is_cuda:
        return ref.dane_update_leaves_ref(w_leaves, g_leaves, c_leaves,
                                          a_leaves, eta, mu, mask)
    if mask is not None:
        mask = _f32_on(mask, w0)
    outs = [torch.empty_like(w) for w in w_leaves]
    arrays = [(w, g, c, a, o, w.numel() // k if k else w.numel())
              for w, g, c, a, o in zip(w_leaves, g_leaves, c_leaves,
                                       a_leaves, outs) if w.numel()]
    if arrays:
        _launch("dane_update_2d", arrays, mask, eta, mu)
    return outs
