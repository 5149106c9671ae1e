"""Blockwise online-softmax attention (K7), its backward, and their
wrappers.

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

:func:`flash_attention_3d` is differentiable: an autograd Function whose
forward also keeps each row's log-sum-exp (the kernel writes it when
asked) and whose backward launches ``csrc/flash_attention_bwd.cu`` (a
kernel with no TPU counterpart: the reference trains through its XLA
attention; on the tensor cores like the forward, deterministic), or on
the CPU takes ``ref.flash_attention_3d_bwd_ref``.  Under
``torch.func.vmap`` both fold the mapped dims into BH, so the K clients
of a ``vmap(grad(loss))`` step cost one forward and one backward launch.
A second derivative raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.vmap_fold import fold, unfold
from repro_torch.kernels.build import F, I, P

#: Head dims the kernel is built for (a template parameter of the source).
HEAD_DIMS = (32, 64, 128)
#: A launch's grid has bh on x and one row block per 128 rows on y.
ROW_BLOCK = 128
MAX_ROWS = 65535 * ROW_BLOCK

_SIGNATURES = {fn: (P, P, P, P, P, I, I, I, I, I, I, F, P)
               for fn in ("flash_attention_f32", "flash_attention_bf16")}
_BWD_SIGNATURES = {fn: (P,) * 10 + (I, I, I, I, I, I, F, P)
                   for fn in ("flash_attention_bwd_f32",
                              "flash_attention_bwd_bf16")}
_FN = {torch.float32: "flash_attention_f32",
       torch.bfloat16: "flash_attention_bf16"}
_BWD_FN = {torch.float32: "flash_attention_bwd_f32",
           torch.bfloat16: "flash_attention_bwd_bf16"}
#: The backward walks 64-row (64-key) tiles, at most 65,535 of them.
BWD_TILE = 64
BWD_MAX_ROWS = 65535 * BWD_TILE
#: Row tiles a dK/dV block walks at most without a period (4,096 rows).
BWD_MAX_WALK = 64
#: The backward's scratch rows of lse and D pad S to a multiple of this.
BWD_ROW_PAD = 128


def bwd_plan(s: int, causal_period: int = 0):
    """The backward's split of a dK/dV block's walk over the ``ceil(s /
    64)`` row tiles: ``(chunk, parts)``, part ``p`` walking tiles
    ``[p * chunk, (p + 1) * chunk)``.  One folded group's tiles a part
    under a period, else at most :data:`BWD_MAX_WALK`; it depends on the
    shapes alone, not on BH, so a vmap fold sums each slice in the order
    of its own call.  ``csrc/flash_attention_bwd.cu`` ``plan`` computes
    the same."""
    n_q = -(-s // BWD_TILE)
    chunk = -(-causal_period // BWD_TILE) if causal_period > 0 \
        else BWD_MAX_WALK
    chunk = max(1, min(chunk, n_q))
    return chunk, -(-n_q // chunk)


def bwd_scratch_floats(bh: int, s: int, t: int, hd: int,
                       causal_period: int = 0) -> int:
    """Floats of the backward's scratch: lse * log2 e and D of ``bh``
    slices of S padded to :data:`BWD_ROW_PAD` rows, then, where the walk
    is split, each part's f32 dK and dV."""
    s_pad = -(-s // BWD_ROW_PAD) * BWD_ROW_PAD
    parts = bwd_plan(s, causal_period)[1]
    return 2 * bh * s_pad + (2 * parts * bh * t * hd if parts > 1 else 0)


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


def flash_attention_3d_fwd(q, k, v, *, causal: bool = True,
                           causal_period: int = 0, with_lse: bool = False):
    """K7's launch: the attention output in ``q``'s dtype and, with
    ``with_lse``, the rows' f32 log-sum-exp ``(BH, S)`` (else None)."""
    _check(q, k, v, causal_period)
    if q.device.type == "cpu":
        res = ref.flash_attention_3d_ref(q, k, v, causal=causal,
                                         causal_period=causal_period,
                                         with_lse=with_lse)
        return res if with_lse else (res, None)
    bh, s, hd = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((bh, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if bh == 0 or s == 0:
        return out, lse
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    lib = build.library("flash_attention", _SIGNATURES)
    rc = getattr(lib, _FN[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), bh, s, k.shape[1], hd,
        int(causal), causal_period, hd ** -0.5, build.stream())
    build.check_launch(rc, "flash_attention_3d")
    build.launch_counts["flash_attention"] += 1
    return out, lse


def flash_attention_3d_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                           causal_period: int = 0):
    """The K7 backward's launch: ``(dq, dk, dv)`` of ``o`` = K7(q, k, v)
    under the cotangent ``do`` (``o``'s shape and dtype), from the
    forward's f32 ``lse`` (BH, S); each in its input's dtype.  On the card
    it runs 3 or 4 CUDA launches (one count), with a scratch of
    :func:`bwd_scratch_floats`; the same inputs give the same bits."""
    _check(q, k, v, causal_period)
    what = "flash_attention_3d_bwd"
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: {name} must be like q {tuple(q.shape)}"
                             f" {q.dtype} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"{what}: lse must be float32 {tuple(q.shape[:2])} "
                         f"on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    if q.device.type == "cpu":
        return ref.flash_attention_3d_bwd_ref(q, k, v, o, do, lse,
                                              causal=causal,
                                              causal_period=causal_period)
    bh, s, hd = q.shape
    t = k.shape[1]
    if max(s, t) > BWD_MAX_ROWS:
        raise ValueError(f"{what}: S = {s}, T = {t}; the backward takes at "
                         f"most {BWD_MAX_ROWS}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if bh == 0 or s == 0:
        return dq, dk.zero_(), dv.zero_()
    q, k, v, o, do = (_aligned(t_) for t_ in (q, k, v, o, do))
    lse = lse.contiguous()
    scratch = torch.empty(bwd_scratch_floats(bh, s, t, hd, causal_period),
                          dtype=torch.float32, device=q.device)
    lib = build.library("flash_attention_bwd", _BWD_SIGNATURES)
    rc = getattr(lib, _BWD_FN[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), scratch.data_ptr(), bh, s, t, hd, int(causal),
        causal_period, hd ** -0.5, build.stream())
    build.check_launch(rc, what)
    build.launch_counts["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K7 with its backward; see the module docstring."""

    @staticmethod
    def forward(q, k, v, causal, causal_period, with_lse):
        return flash_attention_3d_fwd(q, k, v, causal=causal,
                                      causal_period=causal_period,
                                      with_lse=with_lse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, causal_period, _ = inputs
        o, lse = output
        if lse is not None:
            ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.causal_period = causal, causal_period

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if lse is None:
            raise RuntimeError("flash_attention_3d: the forward ran without "
                               "grad mode, so it kept no log-sum-exp")
        dq, dk, dv = _FlashAttentionBwd.apply(
            q, k, v, o, do.contiguous(), lse, ctx.causal, ctx.causal_period)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, causal_period, with_lse):
        o, lse = _FlashAttention.apply(*fold(info, in_dims[:3], q, k, v),
                                       causal, causal_period, with_lse)
        return ((unfold(info, o), unfold(info, lse)),
                (0, None if lse is None else 0))


class _FlashAttentionBwd(torch.autograd.Function):
    """The K7 backward as a function of its own, so that it too folds a
    vmap into BH; it has no derivative."""

    @staticmethod
    def forward(q, k, v, o, do, lse, causal, causal_period):
        return flash_attention_3d_bwd(q, k, v, o, do, lse, causal=causal,
                                      causal_period=causal_period)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash_attention_3d: a second derivative of K7 "
                           "is not implemented")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, do, lse, causal, causal_period):
        grads = _FlashAttentionBwd.apply(
            *fold(info, in_dims[:6], q, k, v, o, do, lse), causal,
            causal_period)
        return tuple(unfold(info, g) for g in grads), (0, 0, 0)


def flash_attention_3d(q, k, v, *, causal: bool = True,
                       causal_period: int = 0):
    """K7: ``softmax(q k^T * hd^-0.5, masked) v`` per bh, accumulated in
    float32, output in ``q``'s dtype.  ``q``: (BH, S, hd); ``k``, ``v``:
    (BH, T, hd).  Under ``causal``, key ``j`` is visible to row ``i`` iff
    ``j <= i % causal_period`` (``j <= i`` for ``causal_period=0``).
    Differentiable once (the K7 backward) and vmappable (one launch for
    the mapped batch); with grad mode off the forward keeps no
    log-sum-exp."""
    return _FlashAttention.apply(q, k, v, causal, causal_period,
                                 torch.is_grad_enabled())[0]
