"""The Mamba selective scan (K8) and its wrapper.

    h = exp(dt_t A) * h + (dt_t x_t) (x) b_t;  y_t = sum_n h[:, :, n] c_t[:, n]

from ``h = 0`` over the S steps of ``xs``, ``dt`` (B, S, di) and ``Bc``,
``Cc`` (B, S, N), with ``A`` (di, N): the reference's ``_mamba_step``
(``repro/models/ssm.py:99-108``) folded over the sequence.  The
reference has no Pallas kernel here (XLA loops its ``lax.scan``); on the
card a Python loop of the step would cost ~8 launches a token, so the
scan is a kernel of the port: ``csrc/selective_scan.cu``, one thread a
(b, i) channel with its N states in registers.  For tensors on the CPU
the wrapper takes the plain version ``kernels/ref.selective_scan_ref``.

The kernel takes float32 only, N of 8 or 16, and contiguous ``xs`` and
``dt``; ``Bc`` and ``Cc`` (in the model, column slices of one product)
are made contiguous here.  It has no backward yet: an input that
requires grad raises on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import I, P

#: State sizes the kernel is built for (a template parameter of the source).
STATE_DIMS = (8, 16)

_SIGNATURES = {"selective_scan_f32": (P, P, P, P, P, P, I, I, I, I, P)}
F32 = torch.float32
#: The C entry point, resolved at its first launch.
_FNS = {}


def _check(xs, dt, Bc, Cc, A) -> None:
    if xs.dim() != 3:
        raise ValueError(f"selective_scan: xs must be (B, S, di), got "
                         f"{tuple(xs.shape)}")
    B, S, di = xs.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"selective_scan: A must be ({di}, N), got "
                         f"{tuple(A.shape)}")
    N = A.shape[1]
    want = {"dt": (B, S, di), "Bc": (B, S, N), "Cc": (B, S, N)}
    for name, t in (("dt", dt), ("Bc", Bc), ("Cc", Cc)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"selective_scan: {name} must be "
                             f"{want[name]}, got {tuple(t.shape)}")
    for name, t in (("dt", dt), ("Bc", Bc), ("Cc", Cc), ("A", A)):
        if t.device != xs.device:
            raise ValueError(f"selective_scan: {name} is on {t.device}, xs "
                             f"on {xs.device}")


def selective_scan(xs, dt, Bc, Cc, A):
    """K8: ``y`` (B, S, di) f32 of the scan (module docstring).  On the
    card it launches the kernel or raises; on the CPU it runs the plain
    version."""
    _check(xs, dt, Bc, Cc, A)
    if xs.device.type == "cpu":
        return ref.selective_scan_ref(xs, dt, Bc, Cc, A)
    if xs.device.type != "cuda":
        raise ValueError(f"selective_scan: tensors on {xs.device}; the "
                         f"kernel runs on CUDA, the plain version on CPU")
    for name, t in (("xs", xs), ("dt", dt), ("Bc", Bc), ("Cc", Cc),
                    ("A", A)):
        if t.dtype != F32:
            raise TypeError(f"selective_scan: {name} must be float32, got "
                            f"{t.dtype}")
        if t.requires_grad:
            raise RuntimeError(f"selective_scan: {name} requires grad; K8's "
                               f"backward is not yet ported")
    for name, t in (("xs", xs), ("dt", dt), ("A", A)):
        if not t.is_contiguous():
            raise ValueError(f"selective_scan: {name} must be contiguous")
    B, S, di = xs.shape
    N = A.shape[1]
    if N not in STATE_DIMS:
        raise ValueError(f"selective_scan: state dim N={N}; the kernel is "
                         f"built for N in {STATE_DIMS}")
    if B > 65535:
        raise ValueError(f"selective_scan: batch {B} > 65535 (the grid's "
                         f"y dim)")
    y = torch.empty_like(xs)
    if y.numel() == 0:
        return y
    f = _FNS.get("selective_scan_f32")
    if f is None:
        f = _FNS["selective_scan_f32"] = build.library(
            "selective_scan", _SIGNATURES).selective_scan_f32
    Bc, Cc = Bc.contiguous(), Cc.contiguous()
    rc = f(xs.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
           A.data_ptr(), y.data_ptr(), B, S, di, N, build.stream())
    build.check_launch(rc, "selective_scan")
    build.launch_counts["selective_scan"] += 1
    return y
