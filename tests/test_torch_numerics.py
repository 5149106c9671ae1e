"""CPU rehearsals of the numerics of the port's redesigned kernels.

K7 (flash attention) and K2 (the whole-epoch local solve) run on the card
in arithmetic that the plain versions in ``kernels/ref.py`` do not use.
These tests emulate that arithmetic in plain PyTorch on the CPU, on numpy-
seeded inputs, and hold it to the plain versions at the tolerances
``chip_smoke.py`` holds the kernels to on the card:

- K7's float32 path multiplies on the tensor cores in three TF32 passes:
  each operand split x = hi + lo with hi = x rounded to TF32 (10 mantissa
  bits, to nearest with ties away from zero) and lo = x - hi, which the
  tensor core reads truncated to TF32; each product taken as lo*hi +
  hi*lo + hi*hi in float32.  It must meet the float32 tolerance (atol
  4e-5, rtol 2e-5); a single TF32 pass must not, which is why the split
  is there;
- K7's bfloat16 path rounds the probabilities P to bfloat16 before P V
  (the register operand of wgmma) while summing the normaliser from the
  float32 values; it must meet the bfloat16 tolerance (atol 4e-3, rtol
  1e-2);
- K2 sums each logit as 32 lane partials (lane l takes the features
  f = l mod 32, in order, by fused multiply-adds) and then a shuffle tree
  that pairs lanes 16, 8, 4, 2 and 1 apart, and the softmax normaliser
  across the lanes the same way, dividing by multiplying with correctly
  rounded reciprocals; over a whole solve it must stay within 1e-4 of the
  plain version (chip_smoke.py's EPOCH_TOL).

The emulations live here, not in the package: the package's plain versions
stay the oracle.
"""
import math

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.kernels import ref

F32_TOL = (4e-5, 2e-5)
BF16_TOL = (4e-3, 1e-2)
EPOCH_TOL = 1e-4
LOG2E = 1.4426950408889634


def _tf32(x):
    """Round float32 ``x`` to TF32 (10 mantissa bits), to nearest with
    ties away from zero, on its bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _truncate_tf32(x):
    """What the tensor core reads of a float32 register: TF32 by
    truncation."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    """x = hi + lo as the kernel splits it: hi rounded to TF32, lo the
    exact rest, read truncated."""
    hi = _tf32(x)
    return hi, _truncate_tf32(x - hi)


def _mm_3xtf32(a, b):
    """``a @ b`` in three TF32 products with float32 sums, the small terms
    first."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) \
        + torch.matmul(ah, bh)


def _mm_tf32(a, b):
    return torch.matmul(_tf32(a), _tf32(b))


def _masked_scores(s, S, T, causal, period):
    if not causal:
        return s
    pos = torch.arange(S)
    if period:
        pos = pos % period
    return torch.where(torch.arange(T)[None, :] <= pos[:, None], s,
                       float("-inf"))


def _attention_tc(q, k, v, causal, period, mm):
    """Float32 attention with both products through ``mm``, normalised at
    the end as the kernel does."""
    hd = q.shape[-1]
    s = mm(q * hd ** -0.5, k.transpose(1, 2))
    s = _masked_scores(s, q.shape[1], k.shape[1], causal, period)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return mm(p, v) / p.sum(dim=-1, keepdim=True)


def _attention_bf16_p(q, k, v, causal, period):
    """bfloat16 attention as the wgmma path computes it: exact bf16
    products summed in float32, a base-2 softmax, P rounded to bfloat16
    for P V, the normaliser from the float32 P."""
    hd = q.shape[-1]
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) \
        * (hd ** -0.5 * LOG2E)
    s = _masked_scores(s, q.shape[1], k.shape[1], causal, period)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = torch.bmm(p.to(torch.bfloat16).float(), v.float())
    return (o / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16)


def _qkv(seed, bh, s, t, hd, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(bh, n, hd)).astype(
        np.float32)).to(dtype) for n in (s, t, t)]


def _excess(got, want, atol, rtol):
    """How far ``got`` lies outside ``atol + rtol * |want|`` (<= 0: in)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - rtol * want.abs()).max()) - atol


# (bh, S, T, hd, causal, period): qwen-like causal MHA at S=1024, yi-like
# GQA-folded rows (G=4 query heads of S=256 on one KV head), non-causal
ATTN_CASES = [
    (2, 1024, 1024, 64, True, 0),
    (2, 4 * 256, 256, 128, True, 256),
    (2, 512, 512, 128, False, 0),
]


@pytest.mark.parametrize("bh,S,T,hd,causal,period", ATTN_CASES)
def test_3xtf32_attention_meets_the_f32_tolerance(bh, S, T, hd, causal,
                                                  period):
    q, k, v = _qkv(S + hd, bh, S, T, hd)
    want = ref.flash_attention_3d_ref(q, k, v, causal=causal,
                                      causal_period=period)
    got = _attention_tc(q, k, v, causal, period, _mm_3xtf32)
    assert _excess(got, want, *F32_TOL) <= 0.0


@pytest.mark.parametrize("bh,S,T,hd,causal,period", ATTN_CASES[:2])
def test_single_tf32_attention_misses_the_f32_tolerance(bh, S, T, hd,
                                                        causal, period):
    """One TF32 pass per product is what wgmma's or mma.sync's TF32 would
    give unsplit: it lands outside the float32 tolerance."""
    q, k, v = _qkv(S + hd, bh, S, T, hd)
    want = ref.flash_attention_3d_ref(q, k, v, causal=causal,
                                      causal_period=period)
    got = _attention_tc(q, k, v, causal, period, _mm_tf32)
    assert _excess(got, want, *F32_TOL) > 0.0


@pytest.mark.parametrize("bh,S,T,hd,causal,period", ATTN_CASES)
def test_bf16_rounded_p_meets_the_bf16_tolerance(bh, S, T, hd, causal,
                                                 period):
    q, k, v = _qkv(S + hd, bh, S, T, hd, torch.bfloat16)
    want = ref.flash_attention_3d_ref(q, k, v, causal=causal,
                                      causal_period=period)
    got = _attention_bf16_p(q, k, v, causal, period)
    assert got.dtype == torch.bfloat16
    assert _excess(got, want, *BF16_TOL) <= 0.0


def _fma(a, b, c):
    """float32 fused multiply-add (the product is exact in float64; the
    sum is rounded once more, which differs from one rounding only at
    ties too rare to matter here)."""
    return (a.double() * b.double() + c.double()).float()


def _lane_tree(p):
    """Sum dim 2 (32 lanes) by the butterfly's pairs: 16, 8, 4, 2, 1
    apart."""
    while p.shape[2] > 1:
        h = p.shape[2] // 2
        p = p[:, :, :h] + p[:, :, h:]
    return p[:, :, 0]


def _lane_tree_sum(e):
    """The softmax normaliser as the warp sums it: lane l adds classes
    l, l + 32, .. in order, then the butterfly."""
    K, B, C = e.shape
    lanes = torch.zeros(K, B, 32)
    for c in range(C):
        lanes[:, :, c % 32] = lanes[:, :, c % 32] + e[:, :, c]
    return _lane_tree(lanes)[..., None]


def _warp_split_epoch(w0, corr, batches, *, eta, mu, num_epochs,
                      step_mask):
    """K2 in the card kernel's order: per row, lane partials over
    f = lane mod 32 by fused multiply-adds, a tree over the lanes (16, 8,
    4, 2, 1 apart), + b; softmax with the normaliser summed across the
    lanes likewise, both divisions as products with reciprocals; the
    gradient of each (f, c) as fused multiply-adds over the B rows."""
    x, y = batches["x"], batches["y"].long()
    K, nb, B, d = x.shape
    C = w0["w"].shape[1]
    lanes = -(-d // 32)
    xp = torch.zeros(K, nb, B, 32 * lanes)
    xp[..., :d] = x
    xp = xp.view(K, nb, B, lanes, 32)
    w = w0["w"].expand(K, d, C).clone()
    b = w0["b"].expand(K, C).clone()
    onehot = torch.nn.functional.one_hot(y, C).float()
    for t in range(num_epochs * nb):
        keep = step_mask[:, t] > 0
        if not bool(keep.any()):
            continue
        j = t % nb
        wp = torch.zeros(K, 32 * lanes, C)
        wp[:, :d] = w
        wp = wp.view(K, lanes, 32, C)
        acc = torch.zeros(K, B, 32, C)
        for s in range(lanes):
            acc = _fma(xp[:, j, :, s, :, None], wp[:, None, s], acc)
        z = _lane_tree(acc) + b[:, None, :]
        e = torch.exp(z - z.amax(dim=-1, keepdim=True))
        r = (e * (1.0 / _lane_tree_sum(e)) - onehot[:, j]) * (1.0 / B)
        g = torch.zeros(K, d, C)
        gb = torch.zeros(K, C)
        for i in range(B):
            g = _fma(x[:, j, i, :, None], r[:, i, None, :], g)
            gb = gb + r[:, i]
        wn = w - eta * (g + corr["w"] + mu * (w - w0["w"]))
        bn = b - eta * (gb + corr["b"] + mu * (b - w0["b"]))
        w = torch.where(keep[:, None, None], wn, w)
        b = torch.where(keep[:, None], bn, b)
    return {"w": w, "b": b}


@pytest.mark.parametrize("K,nb,d,E", [
    (10, 128, 60, 20),     # the paper's synthetic(1,1) solve: 2,560 steps
    (10, 64, 784, 20),     # FEMNIST-like: 1,280 steps at d=784
])
def test_warp_split_logits_hold_the_epoch_tolerance(K, nb, d, E):
    B, C = 10, 10
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(K, nb, B, d)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, C, size=(K, nb, B)).astype(
        np.int32))
    w0 = {"w": torch.from_numpy((0.1 * rng.normal(size=(d, C))).astype(
              np.float32)),
          "b": torch.from_numpy((0.1 * rng.normal(size=C)).astype(
              np.float32))}
    corr = {"w": torch.from_numpy((0.01 * rng.normal(size=(K, d, C)))
                                  .astype(np.float32)),
            "b": torch.from_numpy((0.01 * rng.normal(size=(K, C)))
                                  .astype(np.float32))}
    # devices keep nb - k % 3 of their batches; device 3 is masked out
    valid = torch.zeros(K, nb)
    for k in range(K):
        valid[k, :nb - k % 3] = 1.0
    valid[3] = 0.0
    mask = valid.repeat(1, E)
    kw = dict(eta=0.01, mu=0.001, num_epochs=E, step_mask=mask)
    batches = {"x": x, "y": y}
    want = ref.local_epoch_ref(w0, corr, batches, **kw)
    got = _warp_split_epoch(w0, corr, batches, **kw)
    for name in ("w", "b"):
        err = float((got[name] - want[name]).abs().max())
        assert math.isfinite(err) and err <= EPOCH_TOL, (name, err)
    assert torch.equal(got["w"][3], w0["w"])
