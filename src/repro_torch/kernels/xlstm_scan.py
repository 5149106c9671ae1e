"""The xLSTM scans: mLSTM (K9) and sLSTM (K10), kernels of the port.

K9 folds the reference's ``_mlstm_step`` (``repro/models/xlstm.py:52-68``)
over S steps from ``C = 0``, ``n = 0``, ``m = -1e30``::

    m' = max(log_f + m, log_i);  i = exp(log_i - m');  f = exp(log_f + m - m')
    C  = f C + (i k) v^T;  n = f n + i k
    h  = C^T (q s) / max(|n . (q s)|, 1),   s = dk^-1/2

on q, k, v (B, S, H, dk) and the gates log_i, log_f (B, S, H) -> h (B, S,
H, dk).  K10 folds ``_slstm_step`` (``:141-160``) from ``c = n = h = 0``,
``m = -1e30``, with the per-head recurrent matrices ``r_z``, ``r_i``,
``r_f``, ``r_o`` (H, dh, dh) applied to the previous h every step, on the
projected inputs zx, ix, fx, ox (B, S, H, dh) -> h (B, S, H, dh).

The reference has no Pallas kernel here (XLA loops its ``lax.scan``); on
the card a Python loop of either step would cost 12-20 launches a token
and layer, so each scan is one launch of a hand-written kernel:
``csrc/mlstm_scan.cu`` (a block a (b, head) and 16 columns of C, its
slab of C in registers) and ``csrc/slstm_scan.cu`` (a block a (b, head)
that reads the head's recurrent matrices from L2 every step).

For tensors on the CPU the wrappers take the plain versions
``kernels/ref.mlstm_scan_ref`` / ``slstm_scan_ref``.  The kernels take
float32 only; inputs are made contiguous here.  Both scans serve only:
the backward kernels are not written yet, so an input that requires grad
under grad mode raises (on the CPU too) rather than run a loop autograd
could differentiate.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import F, I, P

F32 = torch.float32
#: Head dims K9 is built for (a template over dk / 16 rows a thread).
MLSTM_DIMS = (64, 128, 256, 512)
#: Head dims K10 takes (its 1,024 threads split evenly over dh^2 / 4).
SLSTM_DIMS = (32, 64, 128, 256)

_MLSTM_SIGNATURES = {"mlstm_scan_f32": (P, P, P, P, P, P, I, I, I, I, F, P)}
_SLSTM_SIGNATURES = {"slstm_scan_f32": (P,) * 9 + (I, I, I, I, P)}


def _refuse_grad(what: str, tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{what}: xLSTM training (the scan's backward "
                         f"kernel) is not yet ported; the scan serves only")


def _check_same(what: str, named, want, device) -> None:
    for name, t in named:
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} must be {want}, got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not "
                             f"{device}")


def _check_card(what: str, named) -> None:
    for name, t in named:
        if t.dtype != F32:
            raise TypeError(f"{what}: {name} must be float32, got "
                            f"{t.dtype}")


def mlstm_scan(q, k, v, log_i, log_f):
    """K9: h (B, S, H, dk) f32 of the mLSTM scan (module docstring).  On
    the card it launches the kernel or raises; on the CPU it runs the
    plain version."""
    what = "mlstm_scan"
    named = (("q", q), ("k", k), ("v", v), ("log_i", log_i),
             ("log_f", log_f))
    _refuse_grad(what, [t for _, t in named])
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, S, H, dk), got "
                         f"{tuple(q.shape)}")
    B, S, H, dk = q.shape
    _check_same(what, named[1:3], (B, S, H, dk), q.device)
    _check_same(what, named[3:], (B, S, H), q.device)
    if q.device.type == "cpu":
        return ref.mlstm_scan_ref(q, k, v, log_i, log_f)
    _check_card(what, named)
    if dk not in MLSTM_DIMS:
        raise ValueError(f"{what}: head dim {dk}; the kernel is built for "
                         f"{MLSTM_DIMS}")
    h = torch.empty((B, S, H, dk), dtype=F32, device=q.device)
    if h.numel() == 0:
        return h
    q, k, v, log_i, log_f = (t.contiguous() for _, t in named)
    lib = build.library(what, _MLSTM_SIGNATURES)
    rc = lib.mlstm_scan_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            log_i.data_ptr(), log_f.data_ptr(), h.data_ptr(),
                            B, S, H, dk, dk ** -0.5, build.stream())
    build.check_launch(rc, what)
    build.launch_counts[what] += 1
    return h


def slstm_scan(zx, ix, fx, ox, r_z, r_i, r_f, r_o):
    """K10: h (B, S, H, dh) f32 of the sLSTM scan (module docstring).  On
    the card it launches the kernel or raises; on the CPU it runs the
    plain version."""
    what = "slstm_scan"
    xs = (("zx", zx), ("ix", ix), ("fx", fx), ("ox", ox))
    rs = (("r_z", r_z), ("r_i", r_i), ("r_f", r_f), ("r_o", r_o))
    _refuse_grad(what, [t for _, t in xs + rs])
    if zx.dim() != 4:
        raise ValueError(f"{what}: zx must be (B, S, H, dh), got "
                         f"{tuple(zx.shape)}")
    B, S, H, dh = zx.shape
    _check_same(what, xs[1:], (B, S, H, dh), zx.device)
    _check_same(what, rs, (H, dh, dh), zx.device)
    if zx.device.type == "cpu":
        return ref.slstm_scan_ref(zx, ix, fx, ox, r_z, r_i, r_f, r_o)
    _check_card(what, xs + rs)
    if dh not in SLSTM_DIMS:
        raise ValueError(f"{what}: head dim {dh}; the kernel is built for "
                         f"{SLSTM_DIMS}")
    h = torch.empty((B, S, H, dh), dtype=F32, device=zx.device)
    if h.numel() == 0:
        return h
    args = [t.contiguous() for _, t in xs + rs]
    lib = build.library(what, _SLSTM_SIGNATURES)
    rc = lib.slstm_scan_f32(*(t.data_ptr() for t in args), h.data_ptr(),
                            B, S, H, dh, build.stream())
    build.check_launch(rc, what)
    build.launch_counts[what] += 1
    return h
