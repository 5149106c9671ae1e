"""The Mamba selective scan (K8), its backward (K8-bwd) and their
autograd Function.

    h = exp(dt_t A) * h + (dt_t x_t) (x) b_t;  y_t = sum_n h[:, :, n] c_t[:, n]

from ``h = 0`` over the S steps of ``xs``, ``dt`` (B, S, di) and ``Bc``,
``Cc`` (B, S, N), with ``A`` (di, N) shared by every batch row, or
(G, di, N) with row ``b`` taking ``A[b // (B // G)]`` (a vmap fold of G
clients, each with its own ``a_log``): the reference's ``_mamba_step``
(``repro/models/ssm.py:99-108``) folded over the sequence.  The
reference has no Pallas kernel here (XLA loops its ``lax.scan``); on the
card a Python loop of the step would cost ~8 launches a token, so the
scan is a kernel of the port: ``csrc/selective_scan.cu``, one thread a
(b, i) channel with its N states in registers.

Training: the reference differentiates ``chunked_scan``, whose chunks
of ``ref.SCAN_CHUNK`` = 64 steps are under ``jax.checkpoint``, so its
BPTT keeps only the chunk-boundary states.  Here that remat lives in
the Function :func:`selective_scan`: with grad on, K8 also writes ``H``
(B, ceil(S / 64), di, N), the state before each chunk, and the backward
``csrc/selective_scan_bwd.cu`` (K8-bwd) recomputes each chunk's states
from ``H`` and walks it back.  (``torch.utils.checkpoint`` cannot do it:
``torch.func.grad`` refuses saved-tensor hooks.)  Both Functions have a
``vmap`` rule that folds the mapped dim into B, so the trainer's
``vmap(grad)`` over K clients launches K8 once and K8-bwd once.

For tensors on the CPU the wrappers take the plain versions
``kernels/ref.selective_scan_fwd_ref`` / ``selective_scan_bwd_ref``.
The kernels take float32 only, N of 8 or 16, and contiguous ``xs`` and
``dt``; ``Bc`` and ``Cc`` (in the model, column slices of one product)
are made contiguous here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import I, P
from repro_torch.kernels.vmap_fold import fold_contiguous, unfold

#: State sizes the kernels are built for (a template parameter).
STATE_DIMS = (8, 16)
#: Steps between the saved states, fixed in both sources.
CHUNK = ref.SCAN_CHUNK
#: K8-bwd's threads a block (``kThreads`` in the source), one a (channel,
#: state): ``BWD_THREADS / N`` channels a block.
BWD_THREADS = 256

_SIGNATURES = {
    "selective_scan_f32": (P, P, P, P, P, P, I, I, I, I, P),
    "selective_scan_states_f32": (P, P, P, P, P, P, P, I, I, I, I, I, P),
}
_BWD_SIGNATURES = {
    "selective_scan_bwd_f32": (P,) * 13 + (I, I, I, I, I, P),
}
F32 = torch.float32


def _check(xs, dt, Bc, Cc, A) -> None:
    if xs.dim() != 3:
        raise ValueError(f"selective_scan: xs must be (B, S, di), got "
                         f"{tuple(xs.shape)}")
    B, S, di = xs.shape
    if A.dim() not in (2, 3) or A.shape[-2] != di:
        raise ValueError(f"selective_scan: A must be ({di}, N) or (G, {di}, "
                         f"N), got {tuple(A.shape)}")
    if A.dim() == 3 and (A.shape[0] == 0 or B % A.shape[0]):
        raise ValueError(f"selective_scan: batch {B} is not a multiple of "
                         f"A's {A.shape[0]} groups")
    N = A.shape[-1]
    want = {"dt": (B, S, di), "Bc": (B, S, N), "Cc": (B, S, N)}
    for name, t in (("dt", dt), ("Bc", Bc), ("Cc", Cc)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"selective_scan: {name} must be "
                             f"{want[name]}, got {tuple(t.shape)}")
    for name, t in (("dt", dt), ("Bc", Bc), ("Cc", Cc), ("A", A)):
        if t.device != xs.device:
            raise ValueError(f"selective_scan: {name} is on {t.device}, xs "
                             f"on {xs.device}")


def _check_card(what, tensors) -> None:
    """The card's kernels: f32 on CUDA, N built for, B within the grid."""
    xs = tensors[0][1]
    if xs.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {xs.device}; the kernel runs "
                         f"on CUDA, the plain version on CPU")
    for name, t in tensors:
        if t.dtype != F32:
            raise TypeError(f"{what}: {name} must be float32, got "
                            f"{t.dtype}")
    for name, t in tensors:
        if name in ("xs", "dt", "A") and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    N = dict(tensors)["A"].shape[-1]
    if N not in STATE_DIMS:
        raise ValueError(f"{what}: state dim N={N}; the kernel is built for "
                         f"N in {STATE_DIMS}")
    if xs.shape[0] > 65535:
        raise ValueError(f"{what}: batch {xs.shape[0]} > 65535 (the grid's "
                         f"y dim)")


def _groups(A) -> int:
    return 1 if A.dim() == 2 else A.shape[0]


def selective_scan_fwd(xs, dt, Bc, Cc, A, *, with_states: bool = False):
    """K8's launch: ``(y, H)``, ``y`` (B, S, di) f32 of the scan (module
    docstring) and, ``with_states``, ``H`` (B, ceil(S / CHUNK), di, N)
    the state before each chunk (else None).  On the card it launches
    the kernel or raises; on the CPU it runs the plain version."""
    _check(xs, dt, Bc, Cc, A)
    if xs.device.type == "cpu":
        if with_states:
            return ref.selective_scan_fwd_ref(xs, dt, Bc, Cc, A, CHUNK)
        return ref.selective_scan_ref(xs, dt, Bc, Cc, A), None
    _check_card("selective_scan", (("xs", xs), ("dt", dt), ("Bc", Bc),
                                   ("Cc", Cc), ("A", A)))
    B, S, di = xs.shape
    N = A.shape[-1]
    y = torch.empty_like(xs)
    H = (torch.empty((B, -(-S // CHUNK), di, N), dtype=F32,
                     device=xs.device) if with_states else None)
    if y.numel() == 0:
        return y, H
    lib = build.library("selective_scan", _SIGNATURES)
    Bc, Cc = Bc.contiguous(), Cc.contiguous()
    if with_states:
        rc = lib.selective_scan_states_f32(
            xs.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            A.data_ptr(), y.data_ptr(), H.data_ptr(), B, S, di, N,
            _groups(A), build.stream())
    else:
        if A.dim() == 3:
            raise ValueError("selective_scan: grouped A takes the training "
                             "forward (with_states=True)")
        rc = lib.selective_scan_f32(
            xs.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            A.data_ptr(), y.data_ptr(), B, S, di, N, build.stream())
    build.check_launch(rc, "selective_scan")
    build.launch_counts["selective_scan"] += 1
    return y, H


def bwd_blocks(di: int, N: int) -> int:
    """K8-bwd's channel blocks a sequence: its partial sums of dBc and dCc
    (the closing launch adds them in block order)."""
    return -(-di // (BWD_THREADS // N))


def selective_scan_bwd(xs, dt, Bc, Cc, A, H, dy):
    """K8-bwd's launch: ``(dxs, ddt, dBc, dCc, dA)`` of the scan under the
    cotangent ``dy`` (B, S, di), from the forward's ``H``; ``dA`` has
    ``A``'s shape (per group for a grouped ``A``).  On the card: the walk
    and a closing launch that adds the blocks' partial sums of dBc and
    dCc and the rows' of dA in a fixed order (no atomics: the same inputs
    give the same bits), one count; on the CPU the plain version."""
    _check(xs, dt, Bc, Cc, A)
    what = "selective_scan_bwd"
    B, S, di = xs.shape
    N = A.shape[-1]
    want = (B, -(-S // CHUNK), di, N)
    if tuple(H.shape) != want or tuple(dy.shape) != (B, S, di):
        raise ValueError(f"{what}: H must be {want} and dy {(B, S, di)}, got "
                         f"{tuple(H.shape)} and {tuple(dy.shape)}")
    if xs.device.type == "cpu":
        return ref.selective_scan_bwd_ref(xs, dt, Bc, Cc, A, H, dy, CHUNK)
    _check_card(what, (("xs", xs), ("dt", dt), ("Bc", Bc), ("Cc", Cc),
                       ("A", A), ("H", H), ("dy", dy)))
    dxs, ddt = torch.empty_like(xs), torch.empty_like(xs)
    dBc = torch.empty((B, S, N), dtype=F32, device=xs.device)
    dCc = torch.empty_like(dBc)
    if xs.numel() == 0:
        return dxs, ddt, dBc.zero_(), dCc.zero_(), torch.zeros_like(A)
    dA = torch.empty_like(A)
    Bc, Cc, H, dy = (t.contiguous() for t in (Bc, Cc, H, dy))
    scratch = torch.empty(2 * B * bwd_blocks(di, N) * S * N + B * di * N,
                          dtype=F32, device=xs.device)
    lib = build.library("selective_scan_bwd", _BWD_SIGNATURES)
    rc = lib.selective_scan_bwd_f32(
        xs.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        A.data_ptr(), H.data_ptr(), dy.data_ptr(), dxs.data_ptr(),
        ddt.data_ptr(), dBc.data_ptr(), dCc.data_ptr(), dA.data_ptr(),
        scratch.data_ptr(), B, S, di, N, _groups(A), build.stream())
    build.check_launch(rc, what)
    build.launch_counts["selective_scan_bwd"] += 1
    return dxs, ddt, dBc, dCc, dA


def _fold_A(info, dim, A, per_client: bool):
    """``A`` for a launch over the folded batch: mapped, its clients'
    groups in client order (G = K or K x G); unmapped, as it is (one A
    for every row) unless ``per_client`` or grouped, then repeated a
    client."""
    if dim is not None:
        A = A.movedim(dim, 0)
    elif per_client or A.dim() == 3:
        A = A.expand((info.batch_size,) + A.shape)
    else:
        return A
    return A.reshape((-1,) + A.shape[-2:]).contiguous()


class _SelectiveScan(torch.autograd.Function):
    """K8 with its backward; see the module docstring."""

    @staticmethod
    def forward(xs, dt, Bc, Cc, A, with_states):
        return selective_scan_fwd(xs, dt, Bc, Cc, A, with_states=with_states)

    @staticmethod
    def setup_context(ctx, inputs, output):
        xs, dt, Bc, Cc, A, _ = inputs
        H = output[1]
        if H is not None:
            ctx.mark_non_differentiable(H)
        ctx.save_for_backward(xs, dt, Bc, Cc, A, H)

    @staticmethod
    def backward(ctx, dy, _dH):
        xs, dt, Bc, Cc, A, H = ctx.saved_tensors
        if H is None:
            raise RuntimeError("selective_scan: the forward ran without grad "
                               "mode, so it kept no chunk states")
        return _SelectiveScanBwd.apply(xs, dt, Bc, Cc, A, H,
                                       dy.contiguous()) + (None,)

    @staticmethod
    def vmap(info, in_dims, xs, dt, Bc, Cc, A, with_states):
        y, H = _SelectiveScan.apply(
            *fold_contiguous(info, in_dims[:4], xs, dt, Bc, Cc),
            _fold_A(info, in_dims[4], A, per_client=False), with_states)
        return ((unfold(info, y), unfold(info, H)),
                (0, None if H is None else 0))


class _SelectiveScanBwd(torch.autograd.Function):
    """K8-bwd as a function of its own, so that it too folds a vmap into
    B; it has no derivative.  Under vmap ``A`` is always taken a client
    (its gradient is each client's own)."""

    @staticmethod
    def forward(xs, dt, Bc, Cc, A, H, dy):
        return selective_scan_bwd(xs, dt, Bc, Cc, A, H, dy)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("selective_scan: a second derivative of K8 is "
                           "not implemented")

    @staticmethod
    def vmap(info, in_dims, xs, dt, Bc, Cc, A, H, dy):
        shape_A = A.shape if in_dims[4] is None else \
            A.movedim(in_dims[4], 0).shape[1:]
        xs, dt, Bc, Cc, H, dy = fold_contiguous(
            info, in_dims[:4] + in_dims[5:], xs, dt, Bc, Cc, H, dy)
        grads = _SelectiveScanBwd.apply(
            xs, dt, Bc, Cc, _fold_A(info, in_dims[4], A, per_client=True),
            H, dy)
        return (tuple(unfold(info, g) for g in grads[:4])
                + (grads[4].reshape((info.batch_size,) + tuple(shape_A)),),
                (0,) * 5)


def selective_scan(xs, dt, Bc, Cc, A):
    """K8: ``y`` (B, S, di) f32 of the scan (module docstring).
    Differentiable once (K8-bwd) and vmappable (one launch for the mapped
    batch).  The states of the backward are kept only where it can run:
    with grad mode on and an input that requires grad; else the launch is
    serving's, which writes ``y`` alone."""
    with_states = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xs, dt, Bc, Cc, A))
    return _SelectiveScan.apply(xs, dt, Bc, Cc, A, with_states)[0]
