"""Fused FedDANE local-update kernels (K1, K4) and their wrappers.

    w' = w - eta * (grad + (g_t - grad F_k(w0)) + mu * (w - w0))

Counterpart of ``repro/kernels/dane_update.py``.  On the card each call
launches the hand-written CUDA kernel of ``csrc/dane_update.cu``; for
tensors on the CPU it takes the plain version in ``kernels/ref.py``.
Four model-sized operand streams and one output make the step
memory-bound; eta and mu arrive as kernel arguments, so one build
serves every round and every algorithm.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import LL, F, I, P

LANES = 128

_SIGNATURES = {
    "dane_update_flat_f32": (P, P, P, P, P, P, LL, LL, F, F, P),
    "dane_update_2d": (P, P, P, P, P, LL, I, F, F, P),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_operands(ops, dtypes, what: str) -> None:
    w = ops[0]
    if w.dim() != 2 or w.shape[1] != LANES:
        raise ValueError(f"{what}: operands must be (rows, {LANES}), "
                         f"got {tuple(w.shape)}")
    for t in ops:
        if t.shape != w.shape or t.dtype != w.dtype or \
                t.device != w.device:
            raise ValueError(f"{what}: operands differ in shape, dtype or "
                             f"device")
    if w.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {w.dtype} not supported "
                        f"(supported: {dtypes})")


def _launch_ready(tensors, what: str) -> None:
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{what}: tensors on {tensors[0].device}; the "
                         f"kernel runs on CUDA, the plain version on CPU")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def dane_update_2d(w, grad, g_corr, anchor, eta, mu):
    """K4: the unmasked step on one leaf's ``(rows, LANES)`` view
    (float32 or bfloat16 storage, float32 arithmetic)."""
    ops = (w, grad, g_corr, anchor)
    _check_operands(ops, (torch.float32, torch.bfloat16), "dane_update_2d")
    if w.device.type == "cpu":
        return ref.dane_update_ref(w, grad, g_corr, anchor, eta=eta, mu=mu)
    _launch_ready(ops, "dane_update_2d")
    lib = build.library("dane_update", _SIGNATURES)
    out = torch.empty_like(w)
    rc = lib.dane_update_2d(
        w.data_ptr(), grad.data_ptr(), g_corr.data_ptr(),
        anchor.data_ptr(), out.data_ptr(), w.numel(), _DTYPE_CODE[w.dtype],
        float(eta), float(mu), build.stream())
    build.check_launch(rc, "dane_update_2d")
    build.launch_counts["dane_update_2d"] += 1
    return out


def dane_update_flat(w, grad, g_corr, anchor, eta, mu, mask,
                     rows_per_dev: int):
    """K1: ONE masked launch over a ``(K*rows_per_dev, LANES)`` f32 flat
    pack (``kernels.flatpack``); devices whose ``(K,)`` mask is not > 0
    keep ``w`` exactly."""
    ops = (w, grad, g_corr, anchor)
    _check_operands(ops, (torch.float32,), "dane_update_flat")
    total_rows = w.shape[0]
    if rows_per_dev <= 0 or total_rows % rows_per_dev:
        raise ValueError(f"dane_update_flat: {total_rows} rows are not a "
                         f"whole number of {rows_per_dev}-row devices")
    k = total_rows // rows_per_dev
    if mask.shape != (k,):
        raise ValueError(f"dane_update_flat: mask shape "
                         f"{tuple(mask.shape)} != ({k},)")
    if w.device.type == "cpu":
        return ref.dane_update_flat_ref(w, grad, g_corr, anchor, eta, mu,
                                        mask, rows_per_dev)
    mask = mask.to(device=w.device, dtype=torch.float32).contiguous()
    _launch_ready(ops, "dane_update_flat")
    lib = build.library("dane_update", _SIGNATURES)
    out = torch.empty_like(w)
    rc = lib.dane_update_flat_f32(
        w.data_ptr(), grad.data_ptr(), g_corr.data_ptr(),
        anchor.data_ptr(), mask.data_ptr(), out.data_ptr(), total_rows,
        rows_per_dev, float(eta), float(mu), build.stream())
    build.check_launch(rc, "dane_update_flat")
    build.launch_counts["dane_update_flat"] += 1
    return out
