"""The xLSTM scans: mLSTM (K9) and sLSTM (K10), their backward (K9-bwd,
K10-bwd) and their autograd Functions, kernels of the port.

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
slab of C in registers, each staged tile's shared values made once a
block and h's sums added beside the steps; :func:`mlstm_plan`) and
``csrc/slstm_scan.cu`` (a thread-block cluster a (b, head), each block
holding its columns of the head's four recurrent matrices in registers
for the whole launch and storing its part of each step's h into every
block's shared memory, which each block's mbarrier counts in;
:func:`slstm_plan` lays it out).

Training: the reference differentiates ``chunked_scan``, whose chunks of
``ref.SCAN_CHUNK`` = 64 steps are under ``jax.checkpoint``.  With grad
on, K9's training launch also writes the state before each chunk (C, n,
m), and K9-bwd (``csrc/mlstm_scan_bwd.cu``) recomputes each chunk's
states from it in sub-chunks that stay in a block's shared memory and
walks them back, a thread-block cluster of column blocks adding their
partial sums.  K10's state is small, so its training launch writes
every step's c, n, m and the four gates' pre-activations, and K10-bwd
(``csrc/slstm_scan_bwd.cu``, the same cluster, each block holding rows
of the matrices) walks t = S-1 .. 0 on them alone; the recurrent matrices' gradients are a product over the
saved h after the walk (``ref.slstm_dr``).  Each Function has a
``vmap`` rule that folds the mapped dim into B, so the trainer's
``vmap(grad)`` over K clients launches each kernel once; under vmap the
sLSTM's matrices go in a client each as groups (G, H, dh, dh), batch row
``b`` taking group ``b // (B // G)``.

For tensors on the CPU the wrappers take the plain versions in
``kernels/ref.py`` (``mlstm_scan_ref``, ``mlstm_scan_fwd_ref``,
``mlstm_scan_bwd_ref`` and the sLSTM's), so the CPU tests run the
Functions and their vmap rules.  The kernels take float32 only; inputs
are made contiguous here.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import F, I, P
from repro_torch.kernels.vmap_fold import fold_contiguous, unfold

F32 = torch.float32
#: Head dims K9 and K9-bwd are built for (templates over dk).
MLSTM_DIMS = (64, 128, 256, 512)
#: Head dims K10 and K10-bwd take (templates over dh; :func:`slstm_plan`).
SLSTM_DIMS = (32, 64, 128, 256)
#: Steps between the states K9's training launch saves, fixed in both
#: sources.
CHUNK = ref.SCAN_CHUNK

_MLSTM_SIGNATURES = {
    "mlstm_scan_f32": (P,) * 6 + (I,) * 8 + (F, P),
    "mlstm_scan_states_f32": (P,) * 9 + (I,) * 8 + (F, P),
}
_MLSTM_BWD_SIGNATURES = {
    "mlstm_scan_bwd_f32": (P,) * 16 + (I,) * 9 + (F, P),
    "mlstm_scan_bwd_resident_clusters": (I, P),
}
_SLSTM_SIGNATURES = {
    "slstm_scan_f32": (P,) * 9 + (I,) * 8 + (P,),
    "slstm_scan_states_f32": (P,) * 16 + (I,) * 9 + (P,),
    "slstm_scan_resident_clusters": (I, I, P),
}
_SLSTM_BWD_SIGNATURES = {
    "slstm_scan_bwd_f32": (P,) * 16 + (I,) * 9 + (P,),
    "slstm_scan_bwd_resident_clusters": (I, P),
}


class SlstmPlan(NamedTuple):
    """How K10 and K10-bwd lay out head dim dh (``Plan`` in
    ``csrc/slstm_cluster.cuh``): every launch passes the first four
    fields, and the kernel refuses a plan other than its own."""
    #: Blocks of the thread-block cluster a (b, head) runs on.
    cluster: int
    #: Columns a block owns: the forward's outputs, the backward's rows of
    #: g_h, and their cell states.
    cols: int
    #: Threads a block, each holding ``rows`` = 64 (dh below 64: dh) of
    #: the block's matrix entries: ``4 * dh / rows`` a column.
    threads: int
    #: Steps of inputs staged in shared memory at a time.
    tile: int
    #: Shared memory of the larger kernel (K10-bwd's) a block.
    shared_bytes: int
    #: On-chip bytes a block: its slice of the four matrices (registers)
    #: and ``shared_bytes``.
    on_chip_bytes: int


def slstm_plan(dh: int) -> SlstmPlan:
    """K10's and K10-bwd's plan for head dim ``dh``: a cluster of the
    fewest blocks that hold a head's four (dh, dh) f32 matrices at no more
    than 128 KiB a block (8 at dh = 256, 2 at 128, 1 at 64 and 32), each
    block owning dh / cluster columns."""
    cluster = max(1, dh * dh // 8192)
    cols = dh // cluster
    rows = min(dh, 64)
    tile = 512 // cols
    threads = cols * 4 * (dh // rows)
    # K10-bwd's (K10's 2 dh + 4,096 floats are fewer): the d_g float4s
    # of two steps, two tiles of 8 arrays of tile + 1 steps of the
    # block's columns, a partial sum a thread, 9 values a column for two
    # steps, and two mbarriers
    shared = 4 * (2 * 4 * dh + 2 * 8 * (tile + 1) * cols + threads
                  + 2 * 9 * cols) + 16
    return SlstmPlan(cluster, cols, threads, tile, shared,
                     16 * dh * cols + shared)


class MlstmPlan(NamedTuple):
    """How K9 and K9-bwd lay out head dim dk (``Layout`` in
    ``csrc/mlstm_scan.cu``, ``Plan`` in ``csrc/mlstm_scan_bwd.cu``): each
    launch passes its kernel's fields, and the kernel refuses a plan
    other than its own."""
    #: K9-bwd's walk: columns of C a block (all dk rows of them).
    cols: int
    #: Steps of a sub-chunk, whose recomputed states of the block's
    #: columns fill 128 KB of its shared memory.
    sub: int
    #: Threads a block, each owning ``dk // threads`` rows of the columns.
    threads: int
    #: Column blocks of a head in a thread-block cluster, whose members
    #: send their partial sums of dq and dk into the shared memory of the
    #: member that owns those rows (``kCluster`` in the source).
    cluster: int
    #: Dynamic shared memory of a walk block.
    shared_bytes: int
    #: K9: columns of C a block, steps of a staged tile, threads a block
    #: (dk, each with 4 rows of 4 columns, and a service warp) and dynamic
    #: shared memory.
    fwd_cols: int
    fwd_tile: int
    fwd_threads: int
    fwd_shared_bytes: int


def mlstm_plan(dk: int) -> MlstmPlan:
    """K9's and K9-bwd's plan for head dim ``dk``.  K9-bwd: blocks of 8
    columns, 2 rows a thread at dk = 512 (else 1), sub-chunks of 4096 / dk
    steps (8 at dk = 512, 64 at 64, where a chunk is one sub-chunk),
    clusters of 2 blocks (the card holds 66 of them, one block an SM on
    all 132, so xlstm-350m's B=1 S=4096 gradient takes two whole waves;
    it holds only 30 clusters of 4 and 15 of 8, PERF.md);
    K9: blocks of 16 columns and dk threads (4 x 4 elements of C each)
    with a service warp, tiles of 16 steps."""
    cols, chunk, cluster = 8, CHUNK, 2
    threads = dk // (2 if dk >= 512 else 1)
    warps = threads // 32
    sub = 4096 // dk
    # the states, n's, two buffers each of the (w, u) rows received from
    # the cluster, of dv's warp partials and of i, the chunk's v and dnum
    # columns and its i, f, dden and max(|den|, 1), and two buffers of
    # the df partials received from the cluster (``Plan::bytes``)
    floats = (sub * dk * cols + sub * dk + 2 * sub * 2 * dk
              + 2 * sub * warps * cols + 2 * sub
              + 2 * chunk * cols + 4 * chunk + 2 * sub * cluster * warps)
    tile, fcols, fwarps = 16, 16, dk // 32
    # two tiles of q, k and v, two of (i, f), two of the warps' partials
    # of h's numerator and of den (``Layout::kFloats``)
    tile_floats = 2 * tile * dk + tile * fcols
    fwd = 2 * tile_floats + 4 * tile + 2 * tile * fwarps * fcols \
        + 2 * tile * fwarps
    return MlstmPlan(cols, sub, threads, cluster, 4 * floats, fcols, tile,
                     dk + 32, 4 * fwd)


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


def _chunks(S: int) -> int:
    return -(-S // CHUNK)


# ---------------------------------------------------------------------------
# mLSTM: K9 and K9-bwd
# ---------------------------------------------------------------------------

def _check_mlstm(what, q, k, v, log_i, log_f, chunk):
    named = (("q", q), ("k", k), ("v", v), ("log_i", log_i),
             ("log_f", log_f))
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, S, H, dk), got "
                         f"{tuple(q.shape)}")
    B, S, H, dk = q.shape
    _check_same(what, named[1:3], (B, S, H, dk), q.device)
    _check_same(what, named[3:], (B, S, H), q.device)
    if q.device.type != "cpu":
        _check_card(what, named)
        if dk not in MLSTM_DIMS:
            raise ValueError(f"{what}: head dim {dk}; the kernel is built "
                             f"for {MLSTM_DIMS}")
        if chunk != CHUNK:
            raise ValueError(f"{what}: chunk {chunk}; the kernel's is "
                             f"{CHUNK}")
    return named


def mlstm_scan_fwd(q, k, v, log_i, log_f, *, with_states: bool = False,
                   chunk: int = CHUNK):
    """K9's launch: ``(h, C, n, m)``, ``h`` (B, S, H, dk) f32 of the scan
    (module docstring) and, ``with_states``, the state before each chunk
    of 64 steps: ``C`` (B, ceil(S / 64), H, dk, dk), ``n`` (B, ceil(S /
    64), H, dk), ``m`` (B, ceil(S / 64), H) (else None).  On the card it
    launches the kernel or raises; on the CPU it runs the plain version
    (``chunk``: the plain version's chunk; the kernel's is 64)."""
    what = "mlstm_scan"
    named = _check_mlstm(what, q, k, v, log_i, log_f, chunk)
    if q.device.type == "cpu":
        if with_states:
            return ref.mlstm_scan_fwd_ref(q, k, v, log_i, log_f, chunk)
        return (ref.mlstm_scan_ref(q, k, v, log_i, log_f, chunk),
                None, None, None)
    B, S, H, dk = q.shape
    h = torch.empty((B, S, H, dk), dtype=F32, device=q.device)
    states = ((torch.empty((B, _chunks(S), H, dk, dk), dtype=F32,
                           device=q.device),
               torch.empty((B, _chunks(S), H, dk), dtype=F32,
                           device=q.device),
               torch.empty((B, _chunks(S), H), dtype=F32, device=q.device))
              if with_states else (None, None, None))
    if h.numel() == 0:
        return (h,) + states
    q, k, v, log_i, log_f = (t.contiguous() for _, t in named)
    plan = mlstm_plan(dk)[5:]
    lib = build.library(what, _MLSTM_SIGNATURES)
    if with_states:
        rc = lib.mlstm_scan_states_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
            log_f.data_ptr(), h.data_ptr(), *(s.data_ptr() for s in states),
            B, S, H, dk, *plan, dk ** -0.5, build.stream())
    else:
        rc = lib.mlstm_scan_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                log_i.data_ptr(), log_f.data_ptr(),
                                h.data_ptr(), B, S, H, dk, *plan,
                                dk ** -0.5, build.stream())
    build.check_launch(rc, what)
    build.launch_counts[what] += 1
    return (h,) + states


def mlstm_bwd_scratch_floats(B: int, S: int, H: int, dk: int) -> int:
    """K9-bwd's scratch, in floats: each cluster's partial sums a step
    (the w and u rows of dq and dk, and df; dk / 8 / cluster clusters a
    head, :func:`mlstm_plan`) and seven (B, S, H) rows of scalars (dh .
    h, den, i, f, the tie shares, di, df; see
    ``csrc/mlstm_scan_bwd.cu``).  No recomputed state: a sub-chunk's
    states stay in a block's shared memory, and the starts of the
    sub-chunks (6/64 of a chunk's state at dk = 512) in each thread's
    local memory, which L2 serves."""
    plan = mlstm_plan(dk)
    n_cl = dk // plan.cols // plan.cluster
    return B * H * n_cl * S * (2 * dk + 1) + 7 * B * S * H


def mlstm_scan_bwd(q, k, v, log_i, log_f, h, C, n, m, dh, *,
                   chunk: int = CHUNK):
    """K9-bwd's launch: ``(dq, dk, dv, dlog_i, dlog_f)`` of the scan under
    the cotangent ``dh`` (B, S, H, dk), from the forward's ``h`` and
    states.  On the card: a prologue (each chunk's gates, den and ``dh .
    h`` a step), the walk (a block a (b, head, 8 columns), chunks last to
    first, each recomputed in sub-chunks whose states stay in the block's
    shared memory; a cluster of column blocks adds their partial sums of
    dq and dk a sub-chunk; :func:`mlstm_plan`), a closing launch that
    adds the clusters' sums in order and one that walks the stabiliser's
    scalar chain back -- no atomics, so the same inputs give the same
    bits -- one count; on the CPU the plain version."""
    what = "mlstm_scan_bwd"
    named = _check_mlstm(what, q, k, v, log_i, log_f, chunk)
    B, S, H, dk = q.shape
    nc = -(-S // chunk)
    _check_same(what, (("h", h), ("dh", dh)), (B, S, H, dk), q.device)
    _check_same(what, (("C", C),), (B, nc, H, dk, dk), q.device)
    _check_same(what, (("n", n),), (B, nc, H, dk), q.device)
    _check_same(what, (("m", m),), (B, nc, H), q.device)
    if q.device.type == "cpu":
        return ref.mlstm_scan_bwd_ref(q, k, v, log_i, log_f, h, C, n, m, dh,
                                      chunk)
    _check_card(what, (("h", h), ("C", C), ("n", n), ("m", m), ("dh", dh)))
    grads = [torch.empty((B, S, H, dk), dtype=F32, device=q.device)
             for _ in range(3)]
    grads += [torch.empty((B, S, H), dtype=F32, device=q.device)
              for _ in range(2)]
    if q.numel() == 0:
        return tuple(g.zero_() for g in grads)
    args = [t.contiguous() for _, t in named] + [
        t.contiguous() for t in (h, C, n, m, dh)]
    scratch = torch.empty(mlstm_bwd_scratch_floats(B, S, H, dk),
                          dtype=F32, device=q.device)
    lib = build.library(what, _MLSTM_BWD_SIGNATURES)
    rc = lib.mlstm_scan_bwd_f32(
        *(t.data_ptr() for t in args), *(g.data_ptr() for g in grads),
        scratch.data_ptr(), B, S, H, dk, *mlstm_plan(dk)[:5], dk ** -0.5,
        build.stream())
    build.check_launch(rc, what)
    build.launch_counts[what] += 1
    return tuple(grads)


def mlstm_resident_clusters(dk: int) -> int:
    """How many clusters of K9-bwd's walk blocks of head dim ``dk`` can be
    resident on the card at once (``cudaOccupancyMaxActiveClusters``).
    Needs the card."""
    count = ctypes.c_int(0)
    rc = build.library("mlstm_scan_bwd", _MLSTM_BWD_SIGNATURES) \
        .mlstm_scan_bwd_resident_clusters(dk, ctypes.addressof(count))
    build.check_launch(rc, "mlstm_resident_clusters")
    return count.value


class _MlstmScan(torch.autograd.Function):
    """K9 with its backward; see the module docstring."""

    @staticmethod
    def forward(q, k, v, log_i, log_f, with_states, chunk):
        return mlstm_scan_fwd(q, k, v, log_i, log_f,
                              with_states=with_states, chunk=chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, log_i, log_f, _, chunk = inputs
        h, C, n, m = output
        if C is not None:
            ctx.mark_non_differentiable(C, n, m)
        ctx.chunk = chunk
        ctx.save_for_backward(q, k, v, log_i, log_f, h, C, n, m)

    @staticmethod
    def backward(ctx, dh, _dC, _dn, _dm):
        q, k, v, log_i, log_f, h, C, n, m = ctx.saved_tensors
        if C is None:
            raise RuntimeError("mlstm_scan: the forward ran without grad "
                               "mode, so it kept no chunk states")
        return _MlstmScanBwd.apply(q, k, v, log_i, log_f, h, C, n, m,
                                   dh.contiguous(), ctx.chunk) + (None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, log_i, log_f, with_states, chunk):
        out = _MlstmScan.apply(
            *fold_contiguous(info, in_dims[:5], q, k, v, log_i, log_f),
            with_states, chunk)
        return (tuple(unfold(info, t) for t in out),
                (0,) + tuple(None if t is None else 0 for t in out[1:]))


class _MlstmScanBwd(torch.autograd.Function):
    """K9-bwd as a function of its own, so that it too folds a vmap into
    B; it has no derivative."""

    @staticmethod
    def forward(q, k, v, log_i, log_f, h, C, n, m, dh, chunk):
        return mlstm_scan_bwd(q, k, v, log_i, log_f, h, C, n, m, dh,
                              chunk=chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("mlstm_scan: a second derivative of K9 is not "
                           "implemented")

    @staticmethod
    def vmap(info, in_dims, *args):
        tensors, chunk = args[:10], args[10]
        grads = _MlstmScanBwd.apply(
            *fold_contiguous(info, in_dims[:10], *tensors), chunk)
        return tuple(unfold(info, g) for g in grads), (0,) * 5


def mlstm_scan(q, k, v, log_i, log_f, chunk: int = CHUNK):
    """K9: h (B, S, H, dk) f32 of the mLSTM scan (module docstring).
    Differentiable once (K9-bwd) and vmappable (one launch for the mapped
    batch).  The chunk states of the backward are kept only where it can
    run: with grad mode on and an input that requires grad; else the
    launch is serving's, which writes h alone.  On the card it launches
    the kernels or raises; on the CPU it runs the plain versions
    (``chunk``: theirs; the kernels' is 64)."""
    with_states = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, log_i, log_f))
    return _MlstmScan.apply(q, k, v, log_i, log_f, with_states, chunk)[0]


# ---------------------------------------------------------------------------
# sLSTM: K10 and K10-bwd
# ---------------------------------------------------------------------------

def _check_slstm(what, xs, rs):
    if xs[0][1].dim() != 4:
        raise ValueError(f"{what}: zx must be (B, S, H, dh), got "
                         f"{tuple(xs[0][1].shape)}")
    B, S, H, dh = xs[0][1].shape
    device = xs[0][1].device
    _check_same(what, xs[1:], (B, S, H, dh), device)
    r0 = rs[0][1]
    if r0.dim() not in (3, 4) or tuple(r0.shape[-3:]) != (H, dh, dh):
        raise ValueError(f"{what}: r_z must be {(H, dh, dh)} or (G, {H}, "
                         f"{dh}, {dh}), got {tuple(r0.shape)}")
    if r0.dim() == 4 and (r0.shape[0] == 0 or B % r0.shape[0]):
        raise ValueError(f"{what}: batch {B} is not a multiple of the "
                         f"recurrent matrices' {r0.shape[0]} groups")
    _check_same(what, rs[1:], tuple(r0.shape), device)
    if device.type != "cpu":
        _check_card(what, xs + rs)
        if dh not in SLSTM_DIMS:
            raise ValueError(f"{what}: head dim {dh}; the kernel is built "
                             f"for {SLSTM_DIMS}")


def _groups(r) -> int:
    return 1 if r.dim() == 3 else r.shape[0]


def slstm_scan_fwd(zx, ix, fx, ox, r_z, r_i, r_f, r_o, *,
                   with_states: bool = False):
    """K10's launch: ``(h, c, n, m, pz, pi, pf, po)``, ``h`` (B, S, H,
    dh) f32 of the scan (module docstring) and, ``with_states``, every
    step's ``ref.SLSTM_STATES`` (each (B, S, H, dh); else None).  The r's
    are (H, dh, dh), or (G, H, dh, dh) groups of batch rows (the training
    launch only).  On the card it launches the kernel or raises; on the
    CPU it runs the plain version."""
    what = "slstm_scan"
    xs = (("zx", zx), ("ix", ix), ("fx", fx), ("ox", ox))
    rs = (("r_z", r_z), ("r_i", r_i), ("r_f", r_f), ("r_o", r_o))
    _check_slstm(what, xs, rs)
    if zx.device.type == "cpu":
        if with_states:
            return ref.slstm_scan_fwd_ref(zx, ix, fx, ox, r_z, r_i, r_f, r_o)
        return ((ref.slstm_scan_ref(zx, ix, fx, ox, r_z, r_i, r_f, r_o),)
                + (None,) * 7)
    B, S, H, dh = zx.shape
    out = [torch.empty((B, S, H, dh), dtype=F32, device=zx.device)
           for _ in range(8 if with_states else 1)]
    out += [None] * (8 - len(out))
    if out[0].numel() == 0:
        return tuple(out)
    args = [t.contiguous() for _, t in xs + rs]
    plan = slstm_plan(dh)[:4]
    lib = build.library(what, _SLSTM_SIGNATURES)
    if with_states:
        rc = lib.slstm_scan_states_f32(
            *(t.data_ptr() for t in args), *(t.data_ptr() for t in out),
            B, S, H, dh, _groups(r_z), *plan, build.stream())
    else:
        if r_z.dim() == 4:
            raise ValueError(f"{what}: grouped recurrent matrices take the "
                             f"training launch (with_states=True)")
        rc = lib.slstm_scan_f32(*(t.data_ptr() for t in args),
                                out[0].data_ptr(), B, S, H, dh, *plan,
                                build.stream())
    build.check_launch(rc, what)
    build.launch_counts[what] += 1
    return tuple(out)


def slstm_scan_bwd(r_z, r_i, r_f, r_o, h, c, n, m, pz, pi, pf, po, dh):
    """K10-bwd's launch: ``(dzx, dix, dfx, dox, dr_z, dr_i, dr_f, dr_o)``
    of the scan under the cotangent ``dh`` (B, S, H, dh), from the
    forward's ``h`` and states; each ``dr`` has its ``r``'s shape (per
    group for grouped r's).  On the card the walk (a cluster a (b,
    head) holding the r's as they are, t = S-1 .. 0, the four recurrent
    products of each step in a fixed order: the same inputs give the
    same bits), one count, then the product ``ref.slstm_dr`` over the
    saved h; on the CPU the plain version."""
    what = "slstm_scan_bwd"
    seq = (("h", h), ("c", c), ("n", n), ("m", m), ("pz", pz), ("pi", pi),
           ("pf", pf), ("po", po), ("dh", dh))
    rs = (("r_z", r_z), ("r_i", r_i), ("r_f", r_f), ("r_o", r_o))
    _check_slstm(what, seq[:4], rs)
    B, S, H, dh_ = h.shape
    _check_same(what, seq[4:], (B, S, H, dh_), h.device)
    if h.device.type == "cpu":
        return ref.slstm_scan_bwd_ref(r_z, r_i, r_f, r_o, h, c, n, m, pz, pi,
                                      pf, po, dh)
    _check_card(what, seq)
    d = [torch.empty((B, S, H, dh_), dtype=F32, device=h.device)
         for _ in range(4)]
    if h.numel() == 0:
        return tuple(t.zero_() for t in d) + tuple(
            torch.zeros_like(r) for _, r in rs)
    r_args = [r.contiguous() for _, r in rs]
    args = [t.contiguous() for _, t in seq]
    lib = build.library(what, _SLSTM_BWD_SIGNATURES)
    rc = lib.slstm_scan_bwd_f32(
        *(t.data_ptr() for t in r_args + args[1:]),
        *(t.data_ptr() for t in d), B, S, H, dh_, _groups(r_z),
        *slstm_plan(dh_)[:4], build.stream())
    build.check_launch(rc, what)
    build.launch_counts[what] += 1
    h_prev = torch.cat([h.new_zeros((B, 1, H, dh_)), args[0][:, :-1]], 1)
    return tuple(d) + tuple(ref.slstm_dr(r, h_prev, d_g)
                            for (_, r), d_g in zip(rs, d))


def slstm_resident_clusters(dh: int, kind: str) -> int:
    """How many clusters of head dim ``dh`` of K10's serving launch
    (``kind`` "serve"), its training launch ("train") or K10-bwd ("bwd")
    can be resident on the card at once (``cudaOccupancyMaxActiveClusters``;
    a launch raises where it is 0).  Needs the card."""
    count = ctypes.c_int(0)
    if kind == "bwd":
        rc = build.library("slstm_scan_bwd", _SLSTM_BWD_SIGNATURES) \
            .slstm_scan_bwd_resident_clusters(dh, ctypes.addressof(count))
    else:
        rc = build.library("slstm_scan", _SLSTM_SIGNATURES) \
            .slstm_scan_resident_clusters(dh, int(kind == "train"),
                                          ctypes.addressof(count))
    build.check_launch(rc, "slstm_resident_clusters")
    return count.value


def _fold_r(info, dims, rs, per_client: bool):
    """The r's for a launch over the folded batch: mapped, their clients'
    groups in client order (G = K or K x G); unmapped, as they are (one
    set for every row) unless ``per_client`` or grouped, then repeated a
    client.  The four are mapped alike or expanded to be."""
    if all(d is None for d in dims) and not per_client and rs[0].dim() == 3:
        return list(rs)
    out = []
    for r, d in zip(rs, dims):
        r = (r.movedim(d, 0) if d is not None
             else r.expand((info.batch_size,) + r.shape))
        out.append(r.reshape((-1,) + r.shape[-3:]).contiguous())
    return out


class _SlstmScan(torch.autograd.Function):
    """K10 with its backward; see the module docstring."""

    @staticmethod
    def forward(zx, ix, fx, ox, r_z, r_i, r_f, r_o, with_states):
        return slstm_scan_fwd(zx, ix, fx, ox, r_z, r_i, r_f, r_o,
                              with_states=with_states)

    @staticmethod
    def setup_context(ctx, inputs, output):
        states = output[1:]
        if states[0] is not None:
            ctx.mark_non_differentiable(*states)
        ctx.save_for_backward(*inputs[4:8], *output)

    @staticmethod
    def backward(ctx, dh, *_):
        saved = ctx.saved_tensors
        if saved[5] is None:
            raise RuntimeError("slstm_scan: the forward ran without grad "
                               "mode, so it kept no states")
        return _SlstmScanBwd.apply(*saved, dh.contiguous()) + (None,)

    @staticmethod
    def vmap(info, in_dims, zx, ix, fx, ox, r_z, r_i, r_f, r_o,
             with_states):
        out = _SlstmScan.apply(
            *fold_contiguous(info, in_dims[:4], zx, ix, fx, ox),
            *_fold_r(info, in_dims[4:8], (r_z, r_i, r_f, r_o), False),
            with_states)
        return (tuple(unfold(info, t) for t in out),
                (0,) + tuple(None if t is None else 0 for t in out[1:]))


class _SlstmScanBwd(torch.autograd.Function):
    """K10-bwd as a function of its own, so that it too folds a vmap into
    B; it has no derivative.  Under vmap the r's are always taken a
    client (their gradients are each client's own)."""

    @staticmethod
    def forward(r_z, r_i, r_f, r_o, h, c, n, m, pz, pi, pf, po, dh):
        return slstm_scan_bwd(r_z, r_i, r_f, r_o, h, c, n, m, pz, pi, pf,
                              po, dh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("slstm_scan: a second derivative of K10 is not "
                           "implemented")

    @staticmethod
    def vmap(info, in_dims, *args):
        rs, seq = args[:4], args[4:]
        shape_r = rs[0].shape if in_dims[0] is None else \
            rs[0].movedim(in_dims[0], 0).shape[1:]
        grads = _SlstmScanBwd.apply(
            *_fold_r(info, in_dims[:4], rs, True),
            *fold_contiguous(info, in_dims[4:], *seq))
        return (tuple(unfold(info, g) for g in grads[:4])
                + tuple(g.reshape((info.batch_size,) + tuple(shape_r))
                        for g in grads[4:]), (0,) * 8)


def slstm_scan(zx, ix, fx, ox, r_z, r_i, r_f, r_o):
    """K10: h (B, S, H, dh) f32 of the sLSTM scan (module docstring).
    Differentiable once (K10-bwd) and vmappable (one launch for the
    mapped batch).  The states of the backward are kept only with grad
    mode on and an input that requires grad; else the launch is
    serving's.  On the card it launches the kernels or raises; on the
    CPU it runs the plain versions."""
    with_states = torch.is_grad_enabled() and any(
        t.requires_grad for t in (zx, ix, fx, ox, r_z, r_i, r_f, r_o))
    return _SlstmScan.apply(zx, ix, fx, ox, r_z, r_i, r_f, r_o,
                            with_states)[0]
