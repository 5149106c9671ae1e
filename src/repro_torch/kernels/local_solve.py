"""Fused local-solve kernels for the paper's linear model family (K2, K3).

Counterpart of ``repro/kernels/local_solve.py``.  For multinomial
logistic regression -- batches ``{"x": (B, d), "y": (B,)}``, params
``{"w": (d, C), "b": (C,)}`` -- a whole local SGD step, and a whole
E-epoch local solve, fuse into one launch:

- :func:`linear_logistic_step` (K3): one masked step of K stacked
  regressions (forward, softmax residual, backprop, correction, prox,
  masked update);
- :func:`local_epoch` (K2): the whole E-epoch solve, with the per-step
  valid mask precomputed by the caller as a ``(K, E*nb)`` table.

Both compute the analytic softmax-NLL gradient rather than autodiff, so
they match the looped reference at atol 1e-5, not bitwise.  On the card
they launch ``csrc/local_solve.cu``; for CPU tensors they take the plain
versions in ``kernels/ref.py``.  Selection goes through the
``SolverSpec`` registry of ``core/client.py``, by the reference's gate
(:func:`_select`): both kernels take every workload it fuses.  K2 runs
in one of two tiers (:func:`epoch_tier`): with its whole state in one
block's shared memory where that fits, else with the weights in global
memory, as K3 always runs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import LL, F, I, P

#: Shared memory one block may use on an H100 (227 KB of the SM's 256 KB).
SMEM_LIMIT = 227 * 1024

#: K2 holds its step table in shared memory as bits, 4096 steps at a time.
EPOCH_WINDOW_WORDS = 128

#: The reference's gate for the fused solvers (``MAX_FUSED_ELEMS`` of
#: ``repro/kernels/local_solve.py``, a VMEM budget in f32 words): they
#: take a workload while ``B*d + 2*d*C`` stays within it.  Copied, so
#: that both packages fuse the same workloads.
MAX_FUSED_ELEMS = 1 << 20

#: Longest step table (E * nb) for which "auto" picks the whole-epoch
#: kernel.  Kept from the reference (a TPU grid-length rule) so that
#: "auto" picks the same modes; to be revisited with card numbers.
MAX_EPOCH_STEPS = 4096

_SIGNATURES = {
    "local_epoch_f32": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, F,
                        P),
    "local_epoch_global_f32": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                               I, F, F, P),
    "linear_logistic_step_f32": (P, P, P, LL, P, LL, P, P, P, P, P, P, P, P,
                                 I, I, I, I, F, F, P),
    "global_scratch_floats": (I, I, I, ctypes.POINTER(ctypes.c_longlong)),
}
F32 = torch.float32


def epoch_smem_bytes(d: int, C: int, B: int) -> int:
    """K2's shared memory in its shared tier: two 8-byte barriers, then
    4-byte words with rows padded to ``RS`` = C rounded up to 4: the
    running w, the correction and the anchor (d*RS each), their biases
    (RS each), the logits and the residual (B*RS each), the batch twice
    (2*B*d floats, 2*B labels: the next kept step's lands while one
    runs), the step table's window (:data:`EPOCH_WINDOW_WORDS`) and two
    slots for the next step."""
    rs = -(-C // 4) * 4
    return 16 + 4 * (3 * d * rs + 3 * rs + 2 * B * rs + 2 * B * d + 2 * B
                     + 2 + EPOCH_WINDOW_WORDS)


def epoch_tier(d: int, C: int, B: int) -> str:
    """Which K2 tier runs a ``(d, C)`` model on batches of ``B``:
    ``"shared"`` where :func:`epoch_smem_bytes` fits one block, else
    ``"global"`` (w, the correction and the anchor in global memory, a
    cluster of up to 8 blocks a device, as K3 runs)."""
    return "shared" if epoch_smem_bytes(d, C, B) <= SMEM_LIMIT else "global"


@functools.lru_cache(maxsize=None)
def _scratch_floats(K: int, B: int, C: int) -> int:
    """Floats of global scratch the global tier takes (its logit partials
    and residual, where they outgrow its shared memory), as the C
    launchers report it; 0: none."""
    n = ctypes.c_longlong()
    build.library("local_solve", _SIGNATURES).global_scratch_floats(
        K, B, C, ctypes.byref(n))
    return n.value


def _scratch(K: int, B: int, C: int, device):
    """The global tier's scratch where its launchers take one, else
    None."""
    n = _scratch_floats(K, B, C)
    return torch.empty(n, dtype=F32, device=device) if n else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_f32(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != F32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")


def _check_cuda(what: str, device, **tensors) -> None:
    if device.type != "cuda":
        raise ValueError(f"{what}: tensors on {device}; the kernel runs "
                         f"on CUDA, the plain version on CPU")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def linear_logistic_step(w, batch, corr, w0, *, eta, mu, mask):
    """K3: one fused masked SGD step for K stacked logistic regressions.

    ``w``/``corr``: ``{"w": (K, d, C), "b": (K, C)}``; ``batch``:
    ``{"x": (K, B, d), "y": (K, B)}`` where each device's ``(B, d)``
    rows are contiguous (a ``[:, j]`` slice of the batch stack is);
    ``w0``: the unstacked anchor; ``mask``: (K,) step mask.
    """
    K, d, C = w["w"].shape
    x = batch["x"].to(F32)
    y = batch["y"].to(torch.int32)
    B = x.shape[1]
    if x.shape != (K, B, d) or y.shape != (K, B) or w["b"].shape != (K, C):
        raise ValueError("linear_logistic_step: shapes disagree")
    if mask.shape != (K,):
        raise ValueError(f"linear_logistic_step: mask shape "
                         f"{tuple(mask.shape)} != ({K},)")
    _check_f32("linear_logistic_step", w=w["w"], b=w["b"], cw=corr["w"],
               cb=corr["b"], w0=w0["w"], b0=w0["b"])
    if x.device.type == "cpu":
        return ref.linear_logistic_step_ref(w, batch, corr, w0, eta=eta,
                                            mu=mu, mask=mask)
    mask = mask.to(device=x.device, dtype=F32).contiguous()
    _check_cuda("linear_logistic_step", x.device, w=w["w"], b=w["b"],
                cw=corr["w"], cb=corr["b"], w0=w0["w"], b0=w0["b"])
    if x.stride()[1:] != (d, 1) or y.stride(1) != 1:
        raise ValueError("linear_logistic_step: each device's batch rows "
                         "must be contiguous")
    lib = build.library("local_solve", _SIGNATURES)
    ow = torch.empty_like(w["w"])
    ob = torch.empty_like(w["b"])
    r = _scratch(K, B, C, x.device)
    rc = lib.linear_logistic_step_f32(
        w["w"].data_ptr(), w["b"].data_ptr(), x.data_ptr(), x.stride(0),
        y.data_ptr(), y.stride(0), corr["w"].data_ptr(),
        corr["b"].data_ptr(), w0["w"].data_ptr(), w0["b"].data_ptr(),
        mask.data_ptr(), ow.data_ptr(), ob.data_ptr(), _ptr(r), K, B, d, C,
        float(eta), float(mu), build.stream())
    build.check_launch(rc, "linear_logistic_step")
    build.launch_counts["linear_logistic_step"] += 1
    return {"w": ow, "b": ob}


def local_epoch(w0, corr, batches, *, eta, mu, num_epochs: int,
                step_mask):
    """K2: a WHOLE E-epoch local solve for K stacked logistic
    regressions in ONE launch.

    ``w0``: unstacked anchor; ``corr``: K-stacked correction;
    ``batches``: ``{"x": (K, nb, B, d), "y": (K, nb, B)}``;
    ``step_mask``: (K, E*nb) per-step keep mask in scan order (epochs
    outer, batches inner).
    """
    d, C = w0["w"].shape
    x = batches["x"].to(F32)
    y = batches["y"].to(torch.int32)
    K, nb, B = x.shape[:3]
    T = num_epochs * nb
    if x.shape != (K, nb, B, d) or y.shape != (K, nb, B):
        raise ValueError("local_epoch: batch shapes disagree with w0")
    if step_mask.shape != (K, T) or corr["w"].shape != (K, d, C) or \
            corr["b"].shape != (K, C):
        raise ValueError("local_epoch: step_mask or corr shape disagrees")
    _check_f32("local_epoch", w0=w0["w"], b0=w0["b"], cw=corr["w"],
               cb=corr["b"])
    if x.device.type == "cpu":
        return ref.local_epoch_ref(w0, corr, batches, eta=eta, mu=mu,
                                   num_epochs=num_epochs,
                                   step_mask=step_mask)
    step_mask = step_mask.to(device=x.device, dtype=F32).contiguous()
    _check_cuda("local_epoch", x.device, x=x, y=y, cw=corr["w"],
                cb=corr["b"], w0=w0["w"], b0=w0["b"])
    lib = build.library("local_solve", _SIGNATURES)
    ow = torch.empty((K, d, C), dtype=F32, device=x.device)
    ob = torch.empty((K, C), dtype=F32, device=x.device)
    args = (x.data_ptr(), y.data_ptr(), corr["w"].data_ptr(),
            corr["b"].data_ptr(), w0["w"].data_ptr(), w0["b"].data_ptr(),
            step_mask.data_ptr(), ow.data_ptr(), ob.data_ptr())
    if epoch_tier(d, C, B) == "shared":
        rc = lib.local_epoch_f32(*args, K, nb, B, d, C, T, float(eta),
                                 float(mu), build.stream())
    else:
        r = _scratch(K, B, C, x.device)
        rc = lib.local_epoch_global_f32(
            *args, _ptr(r), K, nb, B, d, C, T, float(eta), float(mu),
            build.stream())
    build.check_launch(rc, "local_epoch")
    build.launch_counts["local_epoch"] += 1
    return {"w": ow, "b": ob}


# ---------------------------------------------------------------------------
# SolverSpec registration (core/client.py hook)
# ---------------------------------------------------------------------------

def _is_linear_logistic(w0, batches) -> bool:
    """Shape gate: the stacked workload is the paper's logreg family in
    float32 (the kernels' only type)."""
    if not (isinstance(w0, dict) and set(w0) == {"w", "b"}
            and isinstance(batches, dict) and set(batches) == {"x", "y"}):
        return False
    w, b, x, y = w0["w"], w0["b"], batches["x"], batches["y"]
    if not (w.ndim == 2 and b.ndim == 1 and x.ndim == 4 and y.ndim == 3):
        return False
    d, C = w.shape
    if b.shape != (C,) or x.shape[3] != d:
        return False
    if y.dtype.is_floating_point or y.dtype.is_complex or \
            y.dtype == torch.bool:
        return False
    return w.dtype == F32 and b.dtype == F32


def _select(w0, batches, num_epochs: int):
    """The reference's rule: no fused solver past the
    :data:`MAX_FUSED_ELEMS` budget, the whole-epoch kernel up to
    :data:`MAX_EPOCH_STEPS` steps, else the step kernel.  Shared memory
    decides only the tier of K2 (:func:`epoch_tier`)."""
    if not _is_linear_logistic(w0, batches):
        return None
    d, C = w0["w"].shape
    _, nb, B = batches["x"].shape[:3]
    if B * d + 2 * d * C > MAX_FUSED_ELEMS:
        return None
    if num_epochs * nb <= MAX_EPOCH_STEPS:
        return "fused_epoch"
    return "fused_step"


def _make_step(eta):
    def step(w, batch, corr, w0, mu, mask):
        return linear_logistic_step(w, batch, corr, w0, eta=eta, mu=mu,
                                    mask=mask)
    return step


def _make_epoch(eta, num_epochs: int):
    def solve(w0, corr, mu, batches, step_mask):
        return local_epoch(w0, corr, batches, eta=eta, mu=mu,
                           num_epochs=num_epochs, step_mask=step_mask)
    return solve


def register() -> None:
    """Register the linear-logistic fused solver with core/client.py."""
    from repro_torch.core.client import SolverSpec, register_local_solver
    from repro_torch.models.small import logreg_loss
    register_local_solver(logreg_loss, SolverSpec(
        name="linear_logistic",
        summary="softmax-regression step/epoch fused into one launch",
        select=_select,
        make_step=_make_step,
        make_epoch=_make_epoch,
    ))
