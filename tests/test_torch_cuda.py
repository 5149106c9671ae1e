"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and the CUDA toolkit's nvcc (a hand-written
kernel has no CPU form); without a card they skip.  They import no JAX,
so they run where only PyTorch is installed, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  ``chip_smoke.py``
phase 3 holds every kernel at the main path's full shapes.

Tolerance of K7 against its plain version: in float32 the reference's
sweep tolerance (``tests/test_kernels.py``), atol 4e-5 / rtol 2e-5; in
bfloat16 atol 4e-3 / rtol 1e-2, one bf16 ulp (<= 2^-7 |x|) and a margin,
since the kernel and the plain version both compute in float32 and round
once to bfloat16.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import flash_attention_3d
from repro_torch.models import attention as attn

TOL = {torch.float32: (4e-5, 2e-5), torch.bfloat16: (4e-3, 1e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _normal(seed, shape, dtype, device):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,t,hd,causal,period,dtype", [
    (4, 256, 256, 64, True, 0, torch.float32),
    (4, 256, 256, 64, True, 0, torch.bfloat16),
    (2, 1000, 1000, 64, True, 0, torch.float32),     # ragged tails
    (2, 4 * 200, 200, 128, True, 200, torch.float32),  # GQA-folded rows
    (3, 100, 77, 32, False, 0, torch.float32),
    (3, 70, 130, 32, True, 0, torch.bfloat16),
    (1, 1, 1, 128, True, 0, torch.float32),
    # whisper-tiny's cross-attention: B=8 x 6 heads, 448 tokens or one
    # BOS token against 1,500 frames
    (48, 448, 1500, 64, False, 448, torch.float32),
    (48, 1, 1500, 64, False, 1, torch.float32),
])
def test_flash_attention_kernel_matches_plain(card, bh, s, t, hd, causal,
                                              period, dtype):
    q = _normal(1, (bh, s, hd), dtype, card)
    k = _normal(2, (bh, t, hd), dtype, card)
    v = _normal(3, (bh, t, hd), dtype, card)
    build.reset_launch_counts()
    got = flash_attention_3d(q, k, v, causal=causal, causal_period=period)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_attention"] == 1
    want = ref.flash_attention_3d_ref(q, k, v, causal=causal,
                                      causal_period=period)
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Kv,S", [(4, 4, 96), (8, 2, 130)])
def test_model_attention_runs_k7_on_the_card(card, H, Kv, S):
    """``attention`` on CUDA tensors launches K7 once, in the model's head
    order, and agrees with the plain dispatch on the card."""
    q = _normal(4, (2, S, H, 64), torch.float32, card)
    k = _normal(5, (2, S, Kv, 64), torch.float32, card)
    v = _normal(6, (2, S, Kv, 64), torch.float32, card)
    build.reset_launch_counts()
    got = attn.attention(q, k, v, causal=True)
    assert build.launch_counts["flash_attention"] == 1
    want = attn.plain_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, want, atol=4e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("bh,s,t,causal,period", [
    (3, 200, 200, True, 0),          # T not a multiple of the 64-key tile
    (2, 1, 1, True, 0),              # one row, one key
    (2, 1, 77, False, 0),            # one row against a ragged T
    (2, 4 * 200, 200, True, 200),    # a 128-row block straddles a period
])
def test_flash_attention_tensor_core_paths(card, bh, s, t, causal, period,
                                           hd, dtype):
    """K7's two designs (3xTF32 mma.sync for float32, TMA + wgmma for
    bfloat16) at every head dim, on ragged and one-row shapes and GQA-
    folded rows whose period cuts through a block."""
    q = _normal(7, (bh, s, hd), dtype, card)
    k = _normal(8, (bh, t, hd), dtype, card)
    v = _normal(9, (bh, t, hd), dtype, card)
    build.reset_launch_counts()
    got = flash_attention_3d(q, k, v, causal=causal, causal_period=period)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_attention"] == 1
    want = ref.flash_attention_3d_ref(q, k, v, causal=causal,
                                      causal_period=period)
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


#: K2 against its plain version: the tolerance of chip_smoke.py's
#: EPOCH_TOL (thousands of dependent float32 steps whose dot products sum
#: in another order).
EPOCH_TOL = 1e-4


def _epoch_inputs(seed, K, nb, B, d, C, E, device, work=None):
    """A K-device solve: numpy-seeded batches, anchor and correction; device
    k keeps its first ``nb - k % 3`` batches (padding steps masked), device
    min(3, K - 1) none; ``work`` cuts each device's kept steps to
    ``ceil(work * kept)``, as a scenario's work cutoff does."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(K, nb, B, d)).astype(np.float32)
    y = rng.integers(0, C, size=(K, nb, B)).astype(np.int32)
    w0 = {"w": (0.1 * rng.normal(size=(d, C))).astype(np.float32),
          "b": (0.1 * rng.normal(size=(C,))).astype(np.float32)}
    corr = {"w": (0.01 * rng.normal(size=(K, d, C))).astype(np.float32),
            "b": (0.01 * rng.normal(size=(K, C))).astype(np.float32)}
    valid = np.zeros((K, nb), np.float32)
    for j in range(K):
        valid[j, :nb - j % 3] = 1.0
    if K > 1:
        valid[min(3, K - 1)] = 0.0
    mask = np.tile(valid, (1, E))
    if work is not None:
        limit = np.ceil(work * mask.sum(axis=1))
        mask = mask * (np.cumsum(mask, axis=1) <= limit[:, None])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ({k: t(v) for k, v in w0.items()},
            {k: t(v) for k, v in corr.items()},
            {"x": t(x), "y": t(y)}, t(mask.astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("K,nb,B,d,C,E,work", [
    (10, 128, 10, 60, 10, 20, None),   # synthetic(1,1), the paper config
    (10, 64, 10, 784, 10, 20, None),   # FEMNIST-like
    (10, 128, 10, 60, 10, 20, 0.37),   # a work cutoff
    (1, 128, 10, 60, 10, 20, None),    # one device (a rank of the tree,
                                       # a buffered refill of one client)
    (3, 128, 10, 60, 10, 20, None),    # a buffered refill of three
    (3, 128, 10, 60, 10, 20, 0.37),    # ... with a work cutoff
    (3, 7, 5, 33, 18, 700, None),      # E*nb > 4096: the window moves;
                                       # C > 16: two class chunks
    (10, 16, 10, 2000, 10, 20, None),  # the global tier
    (10, 16, 10, 34952, 10, 20, None),  # the largest d the gate takes
    (3, 4, 6, 1500, 21, 3, None),      # global tier, C > 16
    (2, 2, 600, 1200, 10, 2, None),    # partials in global scratch
])
def test_local_epoch_kernel_matches_plain(card, K, nb, B, d, C, E, work):
    """K2 in both tiers against ``local_epoch_ref`` on the card: the
    shared tier (warp-per-row logits, prefetched batches, the step table
    as bits) and, past one block's shared memory, the global tier; the
    device with no kept step keeps the anchor exactly."""
    from repro_torch.kernels import local_solve

    w0, corr, batches, mask = _epoch_inputs(11, K, nb, B, d, C, E, card,
                                            work)
    assert local_solve.epoch_tier(d, C, B) == (
        "shared" if d <= 784 else "global")
    build.reset_launch_counts()
    got = local_solve.local_epoch(w0, corr, batches, eta=0.01, mu=0.001,
                                  num_epochs=E, step_mask=mask)
    torch.cuda.synchronize()
    assert build.launch_counts["local_epoch"] == 1
    want = ref.local_epoch_ref(w0, corr, batches, eta=0.01, mu=0.001,
                               num_epochs=E, step_mask=mask)
    for name in ("w", "b"):
        torch.testing.assert_close(got[name], want[name], atol=EPOCH_TOL,
                                   rtol=0)
    if K > 1:
        idle = min(3, K - 1)
        assert torch.equal(got["w"][idle], w0["w"])
        assert torch.equal(got["b"][idle], w0["b"])


#: K3 against its plain version: one step, a dot product of length d
#: summed in another order (chip_smoke.py's STEP_TOL).
STEP_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("K,B,d,C", [
    (10, 10, 60, 10),       # synthetic(1,1)
    (1, 10, 60, 10),        # a buffered refill of one client
    (3, 10, 60, 10),        # ... of three
    (10, 10, 784, 10),      # FEMNIST-like
    (10, 10, 2000, 10),
    (10, 10, 34952, 10),    # the largest d the gate takes
    (3, 7, 300, 40),        # C > 16: three class chunks
    (2, 3300, 20, 10),      # the residual outgrows shared memory
])
def test_logistic_step_kernel_matches_plain(card, K, B, d, C):
    """K3 (one step, the weights in global memory) against
    ``linear_logistic_step_ref`` on a ``[:, j]`` slice of a stacked batch,
    as the fused_step mode hands it over; the masked device's weights
    come through unchanged."""
    from repro_torch.kernels import local_solve

    w0, corr, batches, _ = _epoch_inputs(12, K, 2, B, d, C, 1, card)
    rng = np.random.default_rng(13)
    w = {"w": torch.from_numpy((0.1 * rng.normal(size=(K, d, C))).astype(
             np.float32)).to(card),
         "b": torch.from_numpy((0.1 * rng.normal(size=(K, C))).astype(
             np.float32)).to(card)}
    batch = {"x": batches["x"][:, 1], "y": batches["y"][:, 1]}
    mask = torch.ones(K, device=card)
    mask[min(1, K - 1)] = 0.0
    build.reset_launch_counts()
    got = local_solve.linear_logistic_step(w, batch, corr, w0, eta=0.01,
                                           mu=0.001, mask=mask)
    torch.cuda.synchronize()
    assert build.launch_counts["linear_logistic_step"] == 1
    want = ref.linear_logistic_step_ref(w, batch, corr, w0, eta=0.01,
                                        mu=0.001, mask=mask)
    for name in ("w", "b"):
        torch.testing.assert_close(got[name], want[name], atol=STEP_TOL,
                                   rtol=0)
        assert torch.equal(got[name][min(1, K - 1)], w[name][min(1, K - 1)])


def _codec_inputs(seed, K, rows, active, device):
    """int8-like code points with per-client scales, as a codec round
    gives them; ``active``: the 0/1 mask as a numpy array."""
    rng = np.random.default_rng(seed)
    vals = np.floor(rng.uniform(-127, 128, (K, rows, 128))).astype(
        np.float32)
    scales = rng.uniform(1e-4, 1e-3, K).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return t(vals), t(scales), t(active.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("K,rows,mask", [
    (10, 8, "one masked"),       # chip_smoke's phase-3 shapes
    (10, 64, "one masked"),
    (5, 8, "one masked"),
    (1, 8, "all active"),
    (2, 64, "all active"),
    (1024, 8, "sparse"),         # the most clients a launch takes
    (1024, 700, "sparse"),       # a slab over all the SMs
    (1024, 8, "all active"),
    (10, 8, "all inactive"),
    (5, 8, "all inactive"),
])
def test_codec_kernels_match_plain_bitwise(card, partial, K, rows, mask):
    """K5 (the mean) and K6 (the partial sum) bitwise equal to their
    plain versions, whose order they keep (clients in order, every
    product and sum rounded on its own); an all-inactive cohort gives
    +0.0, with no sign bit."""
    from repro_torch.kernels import codec

    rng = np.random.default_rng(K * rows)
    active = {"one masked": np.arange(K) != min(3, K - 1),
              "all active": np.ones(K, bool),
              "sparse": rng.uniform(size=K) < 0.05,
              "all inactive": np.zeros(K, bool)}[mask]
    vals, scales, m = _codec_inputs(K + rows, K, rows, active, card)
    fn, plain, name = ((codec.codec_aggregate_partial,
                        ref.codec_aggregate_partial_ref,
                        "codec_aggregate_partial") if partial else
                       (codec.codec_aggregate, ref.codec_aggregate_ref,
                        "codec_aggregate"))
    build.reset_launch_counts()
    got = fn(vals, scales, m)
    torch.cuda.synchronize()
    assert build.launch_counts[name] == 1
    want = plain(vals, scales, m)
    assert got.shape == (rows, 128)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    if mask == "all inactive":
        assert torch.equal(got, torch.zeros_like(got))
        assert not bool(torch.signbit(got).any())


def _bits_equal(a, b) -> bool:
    """Bitwise equality (a float compare would call -0.0 == +0.0)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.cuda
# the synthetic, FEMNIST-like, Sent140 LSTM and Shakespeare LSTM packs
@pytest.mark.parametrize("rows", [8, 64, 480, 6392])
@pytest.mark.parametrize("masked", [0, 1, 10])
def test_dane_update_flat_kernel_matches_plain_bitwise(card, rows, masked):
    """K1 over a (10*rows, 128) f32 pack with 0, 1 or all 10 devices
    masked (the mask a strided column, as the solver hands it over; and
    into a given ``out``): bitwise equal to its plain version, one
    launch a call."""
    from repro_torch.kernels import dane_update

    K = 10
    w, g, c, a = (_normal(40 + i, (K * rows, 128), torch.float32, card)
                  for i in range(4))
    table = torch.ones(K, 3, device=card)
    table[:masked, 1] = 0.0
    mask = table[:, 1]
    build.reset_launch_counts()
    got = dane_update.dane_update_flat(w, g, c, a, 0.01, 0.001, mask, rows)
    out = torch.empty_like(w)
    into = dane_update.dane_update_flat(w, g, c, a, 0.01, 0.001, mask, rows,
                                        out=out)
    torch.cuda.synchronize()
    assert build.launch_counts["dane_update_flat"] == 2 and into is out
    want = ref.dane_update_flat_ref(w, g, c, a, 0.01, 0.001, mask, rows)
    assert _bits_equal(got, want) and _bits_equal(out, want)
    assert _bits_equal(got[:masked * rows], w[:masked * rows])


_LEAF_SHAPES = [(10, 60, 10), (10, 10), (10, 61, 7), (10, 3), (10, 1),
                (10, 128), (10, 0)]


def _leaves(seed, shapes, dtypes, card, offset=0):
    """Numpy-seeded leaves; ``offset``: each a view starting ``offset``
    elements into a larger buffer (misaligned for vector loads)."""
    out = []
    for i, (s, dt) in enumerate(zip(shapes, dtypes)):
        n = int(np.prod(s))
        buf = _normal(seed + i, (n + offset,), dt, card)
        out.append(buf[offset:].view(s))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dane_update_leaves_kernel_matches_plain_bitwise(card, dtype, masked,
                                                         offset):
    """K4's tree launch on leaves whose sizes are not multiples of 4 or of
    128 (and an empty one), aligned and misaligned for vector loads,
    masked (device 3) or not: bitwise equal to the per-leaf plain version
    and its select, one launch for the whole tree."""
    from repro_torch.kernels.dane_update import dane_update_leaves

    dts = [dtype] * len(_LEAF_SHAPES)
    w, g, c, a = (_leaves(60 + 10 * i, _LEAF_SHAPES, dts, card, offset)
                  for i in range(4))
    mask = None
    if masked:
        mask = torch.ones(10, device=card)
        mask[3] = 0.0
    build.reset_launch_counts()
    got = dane_update_leaves(w, g, c, a, 0.05, 0.1, mask)
    torch.cuda.synchronize()
    assert build.launch_counts["dane_update_2d"] == 1
    want = ref.dane_update_leaves_ref(w, g, c, a, 0.05, 0.1, mask)
    for x, y, w_ in zip(got, want, w):
        assert _bits_equal(x, y)
        if masked:
            assert _bits_equal(x[3], w_[3])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [47, 1])     # the synthetic leaves' views
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dane_update_2d_kernel_matches_plain_bitwise(card, rows, dtype):
    from repro_torch.kernels.dane_update import dane_update_2d

    w, g, c, a = (_normal(80 + i, (rows, 128), dtype, card)
                  for i in range(4))
    build.reset_launch_counts()
    got = dane_update_2d(w, g, c, a, 0.01, 0.001)
    torch.cuda.synchronize()
    assert build.launch_counts["dane_update_2d"] == 1
    assert _bits_equal(got, ref.dane_update_ref(w, g, c, a, eta=0.01,
                                                mu=0.001))


@pytest.mark.cuda
def test_dane_update_leaves_chunks_a_long_mixed_tree(card):
    """A tree of 150 leaves, float32 and bfloat16 in turn, takes three
    launches of at most 64 segments, bitwise equal to the plain
    version."""
    from repro_torch.kernels.dane_update import MAX_SEGMENTS, dane_update_leaves

    n = 150
    shapes = [(4, 1 + (7 * i) % 300) for i in range(n)]
    dts = [torch.float32 if i % 2 else torch.bfloat16 for i in range(n)]
    w, g, c, a = (_leaves(1000 * (i + 1), shapes, dts, card)
                  for i in range(4))
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=card)
    build.reset_launch_counts()
    got = dane_update_leaves(w, g, c, a, 0.02, 0.3, mask)
    torch.cuda.synchronize()
    assert build.launch_counts["dane_update_2d"] == -(-n // MAX_SEGMENTS)
    want = ref.dane_update_leaves_ref(w, g, c, a, 0.02, 0.3, mask)
    assert all(_bits_equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_dane_update_wrappers_raise_on_the_card(card):
    """A tensor on the card that the kernel cannot take raises: no copy,
    no plain version."""
    from repro_torch.kernels import dane_update

    w = torch.zeros(16, 128, device=card)
    t = torch.zeros(128, 16, device=card).t()
    with pytest.raises(ValueError, match="contiguous"):
        dane_update.dane_update_2d(w, w, w, t, 0.1, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        dane_update.dane_update_flat(t, w, w, w, 0.1, 0.0,
                                     torch.ones(2, device=card), 8)
    with pytest.raises(ValueError, match="contiguous"):
        dane_update.dane_update_leaves([t], [w], [w], [w], 0.1, 0.0)
    with pytest.raises(ValueError, match="differ"):
        dane_update.dane_update_leaves([w], [w.cpu()], [w], [w], 0.1, 0.0)
    with pytest.raises(TypeError, match="dtype"):
        h = w.half()
        dane_update.dane_update_2d(h, h, h, h, 0.1, 0.0)


@pytest.mark.cuda
def test_flat_and_per_leaf_solves_are_bitwise_equal_on_the_card(card):
    """Three rounds of the batched solver in the flat and per_leaf modes
    (each round's anchor the mean of the last round's devices), K=10 with
    a padding batch and a masked device: bitwise equal, one K1 launch a
    step in flat and one K4 launch a step in per_leaf."""
    from repro_torch.core import client
    from repro_torch.core import pytree as pt
    from repro_torch.models import small

    K, nb, B, d, C, E = 10, 4, 10, 60, 10, 2
    rng = np.random.default_rng(17)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    batches = {"x": t(rng.normal(size=(K, nb, B, d)).astype(np.float32)),
               "y": t(rng.integers(0, C, (K, nb, B)).astype(np.int32))}
    valid = np.ones((K, nb), np.float32)
    valid[1, 3] = 0.0
    valid[3] = 0.0
    valid = t(valid)
    corr = {"w": t(0.01 * rng.normal(size=(K, d, C)).astype(np.float32)),
            "b": t(0.01 * rng.normal(size=(K, C)).astype(np.float32))}
    w0 = {"w": t(0.1 * rng.normal(size=(d, C)).astype(np.float32)),
          "b": t(0.1 * rng.normal(size=C).astype(np.float32))}
    solve = {mode: client.make_batched_solver(
        small.logreg_loss, learning_rate=0.01, num_epochs=E, solver=mode)
        for mode in ("flat", "per_leaf")}
    kernel = {"flat": "dane_update_flat", "per_leaf": "dane_update_2d"}
    anchors = {mode: w0 for mode in solve}
    for _ in range(3):
        for mode, fn in solve.items():
            build.reset_launch_counts()
            res = fn(anchors[mode], corr, 0.001, batches, valid)
            torch.cuda.synchronize()
            assert build.launch_counts[kernel[mode]] == E * nb
            anchors[mode] = pt.tmap(lambda x: x.mean(dim=0), res.params)
        for name in ("w", "b"):
            assert _bits_equal(anchors["flat"][name],
                               anchors["per_leaf"][name])


@pytest.mark.cuda
def test_dane_update_leaves_takes_the_charlstm_tree_in_one_launch(card):
    """K4 over the Shakespeare LSTM's 9 leaves at full width, stacked over
    K=10 devices, device 3 masked: one launch, bitwise equal to the
    per-leaf plain version and its select."""
    from repro_torch.core import pytree as pt
    from repro_torch.kernels.dane_update import dane_update_leaves
    from repro_torch.models.small import charlstm_specs

    shapes = [(10,) + sp.shape for sp in pt.leaves(charlstm_specs(80))]
    assert len(shapes) == 9
    dts = [torch.float32] * len(shapes)
    w, g, c, a = (_leaves(200 + 10 * i, shapes, dts, card)
                  for i in range(4))
    mask = torch.ones(10, device=card)
    mask[3] = 0.0
    build.reset_launch_counts()
    got = dane_update_leaves(w, g, c, a, 0.3, 0.001, mask)
    torch.cuda.synchronize()
    assert build.launch_counts["dane_update_2d"] == 1
    want = ref.dane_update_leaves_ref(w, g, c, a, 0.3, 0.001, mask)
    for x, y, w_ in zip(got, want, w):
        assert _bits_equal(x, y) and _bits_equal(x[3], w_[3])


@pytest.mark.cuda
def test_sent140_round_flat_equals_per_leaf_on_the_card(card):
    """One feddane round of the Sent140 LSTM at full width (Fig. 1's lr
    and E) in the flat and per_leaf modes: bitwise equal params, one K1
    launch a local step in flat and one K4 launch a step in per_leaf."""
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt
    from repro_torch.data import make_sent140_like
    from repro_torch.models.param import init_params
    from repro_torch.models.small import sentlstm_loss, sentlstm_specs

    data = make_sent140_like(40, seed=0)
    p0 = init_params(sentlstm_specs(400), torch.Generator().manual_seed(0))
    out, launches = {}, {}
    for mode in ("flat", "per_leaf"):
        cfg = FederatedConfig(algorithm="feddane", mu=0.001, num_devices=40,
                              devices_per_round=10, local_epochs=2,
                              learning_rate=0.1, local_solver=mode)
        tr = FederatedTrainer(sentlstm_loss, data, cfg)
        build.reset_launch_counts()
        st = tr.round(tr.init(p0))
        torch.cuda.synchronize()
        out[mode] = st.params
        launches[mode] = dict(build.launch_counts)
    assert launches["flat"]["dane_update_flat"] > 0
    assert launches["per_leaf"]["dane_update_2d"] == \
        launches["flat"]["dane_update_flat"]
    assert launches["flat"]["dane_update_2d"] == 0
    for a, b in zip(pt.leaves(out["flat"]), pt.leaves(out["per_leaf"])):
        assert _bits_equal(a, b)


# -- the scanned driver: on-card sampling, captured rounds ------------------

def _scan_setup(card, **over):
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.data import make_synthetic
    from repro_torch.models.param import init_params
    from repro_torch.models.small import logreg_specs

    kw = dict(algorithm="feddane", mu=0.001, num_devices=10,
              devices_per_round=4, local_epochs=2, learning_rate=0.01,
              round_driver="scan", chunk_rounds=2, seed=3)
    kw.update(over)
    data = make_synthetic(1, 1, num_devices=10, seed=0, batch_size=10,
                          device=card)
    p0 = init_params(logreg_specs(60, 10), torch.Generator().manual_seed(0),
                     device=card)
    rng = np.random.default_rng(5)
    sel = np.stack([np.stack([rng.choice(10, 4, replace=False)
                              for _ in range(2)]) for _ in range(3)])
    return FederatedConfig(**kw), data, p0, sel


@pytest.mark.cuda
def test_sampler_marginals_on_the_card(card):
    """The card generator's draws: weighted without replacement against
    numpy's sampler (two-sample chi-square, df=7 at 99.9%: 24.3) and
    uniform against the exact K/N, at 1,000 rounds."""
    from repro_torch.core import server

    n, k, rounds = 8, 3, 1000
    w = np.array([1, 1, 2, 3, 5, 8, 13, 21], np.float64)
    w = w / w.sum()
    rng = np.random.default_rng(0)
    host = np.zeros(n)
    for _ in range(rounds):
        np.add.at(host, server.sample_devices(rng, n, k, p=w), 1.0)
    for p in (w, None):
        gen = torch.Generator(device=card).manual_seed(0)
        pt_ = None if p is None else torch.tensor(p, dtype=torch.float32,
                                                  device=card)
        dev = torch.zeros(n, device=card)
        for _ in range(rounds):
            sel = server.sample_devices_onchip(gen, n, k, p=pt_)
            assert sel.device.type == "cuda"
            dev.index_add_(0, sel, torch.ones(k, device=card))
        dev = dev.cpu().numpy()
        assert dev.sum() == rounds * k
        if p is None:
            expected = rounds * k / n
            assert np.all(np.abs(dev - expected) < 5.0 * np.sqrt(expected))
        else:
            tot = host + dev
            assert float(((host - dev) ** 2 / tot).sum()) < 24.3


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kernel", [("auto", "local_epoch"),
                                         ("flat", "dane_update_flat")])
def test_captured_round_equals_eager_round(card, mode, kernel):
    """3 rounds (two chunks) of the injected-selection program replayed
    from its CUDA graph against the same round body run eagerly on the
    card: bitwise equal history and params; the captured round launches
    the solver's kernel."""
    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt
    from repro_torch.models.small import logreg_loss

    cfg, data, p0, sel = _scan_setup(card, local_solver=mode)
    out = []
    for eager in (False, True):
        tr = FederatedTrainer(logreg_loss, data, cfg)
        assert tr._resolve_driver() == "scan"
        if eager:
            from repro_torch.core.engine import ScannedDriver
            drv = tr._scanned = ScannedDriver(logreg_loss, data, cfg,
                                              engine=tr.engine)
            drv._step = lambda name, fn: fn()
        out.append(tr.run(p0, 3, selections=sel))
        torch.cuda.synchronize()
        if not eager:
            progs = tr._scanned._programs
            assert set(progs) == {"injected", "eval"}
            assert progs["injected"].launches.get(kernel, 0) > 0
    (h1, p1), (h2, p2) = out
    assert h1 == h2
    for a, b in zip(pt.leaves(p1), pt.leaves(p2)):
        assert _bits_equal(a, b)


@pytest.mark.cuda
def test_sampled_program_draws_anew_at_each_replay(card, monkeypatch):
    """The sampled program's generator is registered with its graph:
    consecutive replays select differently, and a second run (the same
    graphs, the generator re-seeded) repeats the first bit for bit."""
    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt
    from repro_torch.core import server
    from repro_torch.models.small import logreg_loss

    cfg, data, p0, _ = _scan_setup(card, chunk_rounds=4)
    tr = FederatedTrainer(logreg_loss, data, cfg)
    rounds = 8
    rec = torch.full((rounds, 2, 4), -1, dtype=torch.long, device=card)
    sample, calls = server.sample_devices_onchip, []

    def spy(*a, **k):
        sel = sample(*a, **k)
        drv = tr._scanned
        phase = len(calls) % 2
        calls.append(phase)
        rec[:, phase].index_copy_(0, drv._ctr[1:2], sel.unsqueeze(0))
        return sel

    monkeypatch.setattr(server, "sample_devices_onchip", spy)
    runs = []
    for _ in range(2):
        h, p = tr.run(p0, rounds)
        runs.append((h, p, rec.cpu().numpy().copy()))
    (h1, p1, s1), (h2, p2, s2) = runs
    assert (s1 >= 0).all() and np.array_equal(s1, s2)
    assert len({s1[t].tobytes() for t in range(rounds)}) > 1
    assert h1 == h2
    for a, b in zip(pt.leaves(p1), pt.leaves(p2)):
        assert _bits_equal(a, b)


@pytest.mark.cuda
def test_launch_counts_grow_with_replays(card):
    """A captured kernel counts once a replay: a first run counts its
    warm-up round and its replays, a second run its replays alone."""
    from repro_torch.core import FederatedTrainer
    from repro_torch.models.small import logreg_loss

    cfg, data, p0, sel = _scan_setup(card, local_solver="flat")
    tr = FederatedTrainer(logreg_loss, data, cfg)
    build.reset_launch_counts()
    tr.run(p0, 3, selections=sel)
    torch.cuda.synchronize()
    per_round = tr._scanned._programs["injected"].launches[
        "dane_update_flat"]
    assert per_round > 0
    assert build.launch_counts["dane_update_flat"] == (1 + 3) * per_round
    build.reset_launch_counts()
    tr.run(p0, 3, selections=sel)
    assert build.launch_counts["dane_update_flat"] == 3 * per_round


# -- the buffered driver: the cohort solves on the card ---------------------

def _buffered_run(device, count_launches=False):
    """feddane under ``hostile`` on the buffered driver (N=8, K=4, M=2,
    polynomial weights), 3 commits, solving on K2 (its plain version on
    the CPU); returns the history, the params on the CPU and the cohort
    launches the driver made."""
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import make_synthetic
    from repro_torch.models.param import init_params
    from repro_torch.models.small import logreg_loss, logreg_specs

    cfg = FederatedConfig(algorithm="feddane", mu=0.001, num_devices=8,
                          devices_per_round=4, local_epochs=2,
                          learning_rate=0.01, seed=7,
                          round_driver="buffered", scenario="hostile",
                          buffer_size=2, straggler_sigma=0.8,
                          local_solver="fused_epoch")
    data = make_synthetic(1, 1, num_devices=8, seed=0, batch_size=10,
                          device=device)
    p0 = init_params(logreg_specs(60, 10), torch.Generator().manual_seed(0),
                     device=device)
    tr = FederatedTrainer(logreg_loss, data, cfg, device=device)
    drv, launches = tr._buffered, []
    launch = drv._launch

    def counted(cohort, *a):
        launches.append(len(cohort))
        return launch(cohort, *a)

    drv._launch = counted
    hist, p = tr.run(p0, 3)
    return hist, {k: v.cpu() for k, v in p.items()}, launches


@pytest.mark.cuda
def test_buffered_run_on_the_card_equals_the_cpu(card):
    """The event stream comes from the host alone, so the card's run has
    the CPU's telemetry exactly; the cohorts solve on K2 against its
    plain version on the CPU (atol 1e-5), one K2 launch a cohort
    launch."""
    hist_c, p_c, launches_c = _buffered_run("cpu")
    build.reset_launch_counts()
    hist_g, p_g, launches_g = _buffered_run(card)
    torch.cuda.synchronize()
    assert list(hist_g) == list(hist_c)
    for k in hist_c:
        if k == "loss":
            np.testing.assert_allclose(hist_g[k], hist_c[k], atol=1e-5)
        else:
            assert hist_g[k] == hist_c[k], k
    for k in p_c:
        torch.testing.assert_close(p_g[k], p_c[k], atol=1e-5, rtol=0)
    assert launches_g == launches_c and len(launches_g) > 1
    assert build.launch_counts["local_epoch"] == len(launches_g)
    assert build.launch_counts["codec_aggregate"] == 0


# -- the population layer: streaming on the card ----------------------------

@pytest.mark.cuda
def test_eager_draws_equal_graph_replays(card):
    """The registered generator gives the same numbers drawn eagerly as
    drawn by replays of a captured program that makes the same calls
    (the streaming schedule draws eagerly what the stacked plan draws
    inside its graph), and the replays advance the generator as the
    eager draws do."""
    from repro_torch.core import server

    n, k = 1000, 10
    gen = torch.Generator(device=card)

    def draws():
        return torch.cat([server.sample_devices_onchip(gen, n, k),
                          server.sample_devices_onchip(gen, n, k),
                          (torch.rand(n, generator=gen, device=card)
                           * 1e6).long()])

    gen.manual_seed(7)
    eager = [draws() for _ in range(4)]
    gen.manual_seed(7)
    out = torch.zeros_like(eager[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        state = gen.get_state()
        draws()                                   # warm-up
        gen.set_state(state)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out.copy_(draws())
    gen.manual_seed(7)
    replayed = []
    for _ in range(4):
        graph.replay()
        replayed.append(out.clone())
    assert all(torch.equal(a, b) for a, b in zip(eager, replayed))
    after = draws()                           # eager again, after replays
    gen.manual_seed(7)
    for _ in range(4):
        draws()
    assert torch.equal(after, draws())


@pytest.mark.cuda
@pytest.mark.parametrize("algo,scenario", [("feddane", "ideal"),
                                           ("scaffold", "ideal"),
                                           ("feddane", "bernoulli")])
def test_streaming_equals_stacked_on_the_card(card, algo, scenario):
    """The scanned driver's streaming plan against its stacked plan on
    one streaming source, sampled on the card: the selections bitwise
    (the schedule's eager draws, the stacked round's in-graph draws),
    the history's participation exactly, params within 1e-5; one
    streaming capture per padded batch count."""
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import FederatedTrainer, engine, server
    from repro_torch.core import pytree as pt
    from repro_torch.data import make_synthetic_stream
    from repro_torch.models.param import init_params
    from repro_torch.models.small import logreg_loss, logreg_specs

    src = make_synthetic_stream(1, 1, num_devices=30, seed=0)
    p0 = init_params(logreg_specs(60, 10), torch.Generator().manual_seed(0),
                     device=card)
    rounds = 4
    staged = []
    stage = engine.ScannedDriver._stream_stage

    def spy_stage(self, off, rows, wire_rows):
        staged.extend(np.stack([r["s1"], r["sel_solve"]]) for r in rows)
        return stage(self, off, rows, wire_rows)

    out = {}
    for plan in ("streaming", "stacked"):
        cfg = FederatedConfig(algorithm=algo, num_devices=30,
                              devices_per_round=10, local_epochs=1,
                              learning_rate=0.05, mu=0.01, seed=5,
                              round_driver="scan", client_source=plan,
                              chunk_rounds=2, scenario=scenario,
                              avail_prob=0.7)
        tr = FederatedTrainer(logreg_loss, src, cfg)
        rec = torch.full((rounds, 2, 10), -1, dtype=torch.long, device=card)
        calls = []
        sample = server.sample_devices_onchip

        def spy(*a, **k):
            sel = sample(*a, **k)
            phase = len(calls) % 2 if algo == "feddane" else 0
            calls.append(phase)
            rec[:, phase].index_copy_(0, tr._scanned._ctr[1:2],
                                      sel.unsqueeze(0))
            if algo != "feddane":
                rec[:, 1].index_copy_(0, tr._scanned._ctr[1:2],
                                      sel.unsqueeze(0))
            return sel

        engine.ScannedDriver._stream_stage = spy_stage
        server.sample_devices_onchip = spy if plan == "stacked" else sample
        try:
            h, p = tr.run(p0, rounds)
        finally:
            engine.ScannedDriver._stream_stage = stage
            server.sample_devices_onchip = sample
        torch.cuda.synchronize()
        out[plan] = (h, p, rec.cpu().numpy(), tr._scanned)
    (hs, ps, _, ds), (ht, pt_, rt, dt) = out["streaming"], out["stacked"]
    assert ds.streaming and not dt.streaming
    assert 1 <= ds.stream_captures == len(ds._sbufs) <= 5
    assert np.array_equal(np.stack(staged), rt) and (rt >= 0).all()
    assert {k: v for k, v in hs.items() if k != "loss"} == \
        {k: v for k, v in ht.items() if k != "loss"}
    np.testing.assert_allclose(hs["loss"], ht["loss"], atol=1e-5)
    for a, b in zip(pt.leaves(ps), pt.leaves(pt_)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=1e-5)


# -- the scanned driver on the client mesh: segments split at collectives ----

@pytest.mark.cuda
def test_segmented_mesh_replay_equals_eager_rounds(card, monkeypatch,
                                                   tmp_path):
    """On 2 gloo ranks sharing the card: the scanned driver's mesh round,
    captured as CUDA-graph segments split at its collectives and replayed
    with the all-reduces between them, equals the same rounds run eagerly
    on the card, bitwise (history and params), for feddane on injected
    selections and for feddane under ``hostile`` with int8, sampled on
    the card over two chunks.  Each round program has several segments,
    the eval two (its psum); both ranks end bitwise equal."""
    import tempfile

    import _torch_mesh_drivers_child as child
    from repro_torch.core import sharding
    from repro_torch.models.param import init_params, params_to_numpy
    from repro_torch.models.small import logreg_specs

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    kw = dict(algorithm="feddane", mu=0.001, num_devices=16,
              devices_per_round=8, local_epochs=2, learning_rate=0.01,
              seed=3, round_driver="scan")
    rng = np.random.default_rng(5)
    sel = np.stack([np.stack([rng.choice(16, 8, replace=False)
                              for _ in range(2)]) for _ in range(3)])
    cases = {
        "feddane": dict(kw=kw, data=("dense", 16), rounds=3, sel=sel),
        "hostile_int8": dict(kw=dict(kw, scenario="hostile", codec="int8",
                                     chunk_rounds=2),
                             data=("dense", 16), rounds=3, sel=None)}
    p0 = params_to_numpy(init_params(logreg_specs(60, 10),
                                     torch.Generator().manual_seed(0)))
    res = sharding.run_on_mesh(child.segmented_vs_eager, 2,
                               args=(cases, p0), device="cuda:0",
                               backend="gloo")
    for name in cases:
        (rep, eager), other = res[0][name], res[1][name]
        assert rep["hist"] == eager["hist"], name
        for k in rep["params"]:
            assert np.array_equal(rep["params"][k].view(np.int32),
                                  eager["params"][k].view(np.int32)), name
            assert np.array_equal(rep["params"][k].view(np.int32),
                                  other[0]["params"][k].view(np.int32))
        progs = rep["programs"]
        rounds = [v for k, v in progs.items() if k != "eval"]
        assert rounds and all(seg >= 3 for seg, _ in rounds), progs
        assert progs["eval"] == (2, 1), progs
        assert eager["programs"] == {}


# ---------------------------------------------------------------------------
# K7's backward and LM training on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,t,hd,causal,period,dtype", [
    (3, 200, 200, 64, True, 0, torch.float32),       # ragged tails
    (2, 4 * 200, 200, 128, True, 200, torch.float32),  # GQA-folded rows
    (2, 3 * 90, 60, 32, True, 90, torch.float32),    # T under the period
    (3, 100, 77, 32, False, 0, torch.float32),
    (3, 130, 130, 64, True, 0, torch.bfloat16),
    (2, 1, 1, 128, True, 0, torch.float32),
    # the wgmma path at every head dim, non-causal, ragged with T < 64
    (2, 300, 300, 32, True, 0, torch.bfloat16),
    (2, 260, 260, 128, True, 0, torch.bfloat16),
    (3, 192, 192, 64, False, 0, torch.bfloat16),
    (2, 100, 50, 64, True, 0, torch.bfloat16),
    # 8 folded groups at hd=128: the split walk and its closing sum
    (1, 8 * 256, 256, 128, True, 256, torch.float32),
    (1, 8 * 256, 256, 128, True, 256, torch.bfloat16),
    # S != T; a walk past 4,096 rows without a period (split in 2)
    (2, 300, 170, 64, True, 0, torch.float32),
    (2, 130, 300, 64, False, 0, torch.float32),
    (1, 4160, 4160, 32, True, 0, torch.float32),
    # whisper-tiny's cross-attention in training: 448 tokens, 1,500 frames
    (48, 448, 1500, 64, False, 448, torch.float32),
])
def test_flash_attention_backward_matches_plain(card, bh, s, t, hd, causal,
                                                period, dtype):
    """The K7 backward (one count, 3 or 4 CUDA launches) against the
    explicit formula on the card, from the forward kernel's lse; K7's own
    tolerance."""
    q = _normal(11, (bh, s, hd), dtype, card)
    k = _normal(12, (bh, t, hd), dtype, card)
    v = _normal(13, (bh, t, hd), dtype, card)
    do = _normal(14, (bh, s, hd), dtype, card)
    o, lse = fa.flash_attention_3d_fwd(q, k, v, causal=causal,
                                       causal_period=period, with_lse=True)
    _, want_lse = ref.flash_attention_3d_ref(q, k, v, causal=causal,
                                             causal_period=period,
                                             with_lse=True)
    torch.testing.assert_close(lse, want_lse, atol=4e-5, rtol=2e-5)
    build.reset_launch_counts()
    got = fa.flash_attention_3d_bwd(q, k, v, o, do, lse, causal=causal,
                                    causal_period=period)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_attention_bwd"] == 1
    want = ref.flash_attention_3d_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                          causal_period=period)
    atol, rtol = TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_is_bitwise_repeatable(card, dtype):
    """Two calls give the same bits (no atomics; the split walk's parts
    summed in a fixed order), under a period that splits the walk."""
    bh, s, t, hd, period = 2, 4 * 512, 512, 128, 512
    q = _normal(21, (bh, s, hd), dtype, card)
    k = _normal(22, (bh, t, hd), dtype, card)
    v = _normal(23, (bh, t, hd), dtype, card)
    do = _normal(24, (bh, s, hd), dtype, card)
    o, lse = fa.flash_attention_3d_fwd(q, k, v, causal=True,
                                       causal_period=period, with_lse=True)
    assert fa.bwd_plan(s, period)[1] == 4
    first = fa.flash_attention_3d_bwd(q, k, v, o, do, lse, causal=True,
                                      causal_period=period)
    second = fa.flash_attention_3d_bwd(q, k, v, o, do, lse, causal=True,
                                       causal_period=period)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_vmap_grad_folds_into_one_launch_each(card):
    """``vmap(grad)`` over 3 clients: one forward and one backward
    launch, each client's gradient equal to its own ``grad``."""
    from torch.func import grad, vmap
    q, k, v = (_normal(15 + i, (3, 4, 100, 64), torch.float32, card)
               for i in range(3))
    w = _normal(18, (4, 100, 64), torch.float32, card)

    def f(q, k, v):
        return (flash_attention_3d(q, k, v, causal=True) * w).sum()

    build.reset_launch_counts()
    g = vmap(grad(f, argnums=(0, 1, 2)))(q, k, v)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_attention"] == 1
    assert build.launch_counts["flash_attention_bwd"] == 1
    for i in range(3):
        for a, b in zip(g, grad(f, argnums=(0, 1, 2))(q[i], k[i], v[i])):
            assert torch.equal(a[i], b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "yi-9b"])
def test_loss_grad_on_the_card_matches_the_cpu(card, arch):
    """``loss_fn``'s gradient through K7 and its backward (hd=32, the
    GQA fold on yi-9b) against the CPU path's plain attention: the loss
    within 1e-5 relative, each leaf within 1e-4 x its max |g|; one
    forward and one backward launch a layer."""
    from repro_torch.configs import get_arch
    from repro_torch.core import pytree as pt
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import init_params, model_specs, transformer
    cfg = get_arch(arch).reduced(num_layers=2, d_model=128, num_heads=4,
                                 num_kv_heads=2, vocab_size=128)
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    toks = torch.from_numpy(np.random.default_rng(19).integers(
        0, 128, (2, 33)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want_l, want_g = value_and_grad(
        lambda p: transformer.loss_fn(p, batch, cfg, remat="none"), params)
    build.reset_launch_counts()
    got_l, got_g = value_and_grad(
        lambda p: transformer.loss_fn(
            p, pt.tmap(lambda x: x.to(card), batch), cfg, remat="full"),
        pt.tmap(lambda x: x.to(card), params))
    torch.cuda.synchronize()
    assert build.launch_counts["flash_attention"] == 2 * cfg.num_layers
    assert build.launch_counts["flash_attention_bwd"] == cfg.num_layers
    assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(float(want_l))
    for a, b in zip(pt.leaves(got_g), pt.leaves(want_g)):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-4 * float(b.abs().max())


def _exact_moe_inputs(seed, B, S, d, E, router):
    """Hidden states in {-1, 0, 1} and a router in {-1, 0, 1} / 1024:
    every router logit is exact in f32, on the card as on the CPU, so
    both devices see the same ties and the same order of the rest.
    ``router``: "random", "zero" or "duplicated" (odd columns copies of
    the even ones)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-1, 2, (B, S, d)).astype(np.float32)
    r = np.zeros((d, E), np.float32)
    if router == "random":
        r[:] = rng.integers(-1, 2, (d, E)) / 1024
    elif router == "duplicated":
        r[:, 0::2] = rng.integers(-1, 2, (d, E // 2)) / 1024
        r[:, 1::2] = r[:, 0::2]
    return torch.from_numpy(x), torch.from_numpy(r)


def _moe_layer(E, K, dense, router, seed=0, d=64, S=200):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe, param
    cfg = MoEConfig(num_experts=E, top_k=K, dense_residual=dense,
                    dense_residual_d_ff=48 if dense else 0)
    p = param.init_params(moe.moe_specs(d, 96, cfg),
                          torch.Generator().manual_seed(seed), device="cpu")
    x, p["router"] = _exact_moe_inputs(seed, 2, S, d, E, router)
    return cfg, p, x


@pytest.mark.cuda
@pytest.mark.parametrize("E,K,dense", [(8, 2, False), (128, 8, False),
                                       (8, 2, True)])
def test_moe_ffn_on_the_card_matches_the_cpu(card, E, K, dense):
    """``moe_ffn`` on the card against the CPU path (B=2, S=200, d=64):
    the experts and slots exactly, outputs within 1e-5 x max |out|, the
    aux within 1e-6; and against the per-expert plain version on the
    card."""
    from repro_torch.core import pytree as pt
    from repro_torch.models import moe
    cfg, p, x = _moe_layer(E, K, dense, "random")
    pc, xc = pt.tmap(lambda t: t.to(card), p), x.to(card)
    want, want_aux = moe.moe_ffn(p, x, cfg)
    got, got_aux = moe.moe_ffn(pc, xc, cfg)
    r, rc = moe.route(p, x, cfg), moe.route(pc, xc, cfg)
    Cb = moe.group_capacity(x.shape[1], cfg)
    assert torch.equal(rc.idx.cpu(), r.idx)
    assert torch.equal(moe.slots(rc.idx, E, Cb).cpu(),
                       moe.slots(r.idx, E, Cb))
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6
    plain, plain_aux = moe.moe_ffn_plain(pc, xc, cfg)
    assert float((plain - got).abs().max()) <= 1e-5 * scale
    assert abs(float(plain_aux) - float(got_aux)) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("router", ["zero", "duplicated"])
def test_moe_ties_on_the_card_match_the_cpu(card, router):
    """E=128, K=8: a zero router and one with duplicated columns give
    the CPU path's experts, order and slots on the card, the lower expert
    first among equals (``jax.lax.top_k``'s rule)."""
    from repro_torch.core import pytree as pt
    from repro_torch.models import moe
    cfg, p, x = _moe_layer(128, 8, False, router, seed=3, S=256)
    r = moe.route(p, x, cfg)
    rc = moe.route(pt.tmap(lambda t: t.to(card), p), x.to(card), cfg)
    Cb = moe.group_capacity(x.shape[1], cfg)
    assert torch.equal(rc.idx.cpu(), r.idx)
    assert torch.equal(moe.slots(rc.idx, 128, Cb).cpu(),
                       moe.slots(r.idx, 128, Cb))
    if router == "zero":
        assert bool((r.idx == torch.arange(8)).all())


def _moe_grads(cfg, p, x, w, cf=1.25):
    """d/dp of sum(w * moe_ffn(p, x)) + aux, x the data of one client."""
    from torch.func import grad

    from repro_torch.models import moe

    def f(p, x):
        out, aux = moe.moe_ffn(p, x, cfg, cf)
        return (out * w).sum() + aux
    return f, grad(f)


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [1.25, 0.05])
@pytest.mark.parametrize("E,K,dense", [(8, 2, True), (128, 8, False)])
def test_moe_vmap_grad_on_the_card_equals_separate_grads(card, E, K, dense,
                                                         cf):
    """``vmap(grad)`` of ``moe_ffn`` over 3 clients' data on the card
    (vmap's fallback off), at a capacity factor that drops pairs and one
    that drops few: each client's gradient within 1e-6 x max |g| of its
    own ``grad`` (bit for bit where cuBLAS takes the same kernel for the
    batched and the single products), relative to the gradient's max
    |g|, and two runs of each bitwise equal."""
    import torch._C._functorch as functorch
    from torch.func import vmap

    from repro_torch.core import pytree as pt
    cfg, p, _ = _moe_layer(E, K, dense, "random", seed=4)
    p = pt.tmap(lambda t: t.to(card), p)
    x = _normal(5, (3, 2, 96, 64), torch.float32, card)
    w = _normal(6, (2, 96, 64), torch.float32, card)
    f, g1 = _moe_grads(cfg, p, x, w, cf)
    was = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    try:
        got = vmap(g1, in_dims=(None, 0))(p, x)
        again = vmap(g1, in_dims=(None, 0))(p, x)
    finally:
        functorch._set_vmap_fallback_enabled(was)
    for a, b in zip(pt.leaves(got), pt.leaves(again)):
        assert torch.equal(a, b)
    for i in range(3):
        want = g1(p, x[i])
        g_max = max(float(b.abs().max()) for b in pt.leaves(want))
        for a, b in zip(pt.leaves(pt.index(got, i)), pt.leaves(want)):
            assert float((a - b).abs().max()) <= 1e-6 * g_max
        for a, b in zip(pt.leaves(want), pt.leaves(g1(p, x[i]))):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_moe_trainer_flat_equals_per_leaf_on_the_card(card, arch):
    """``launch/train.py`` on a reduced MoE arch (1 layer, d=128), one
    feddane round of K=2 in the flat and per_leaf modes: bitwise equal
    params, K1 once a local step in flat and K4 once a step in per_leaf,
    K7 and its backward launched."""
    from repro_torch.core import pytree as pt
    from repro_torch.launch import train
    argv = ["--arch", arch, "--rounds", "1", "--num-devices", "4",
            "--devices-per-round", "2", "--local-epochs", "1",
            "--samples-per-device", "8", "--seq-len", "16", "--d-model",
            "128", "--layers", "1", "--vocab", "128"]
    out, grew = {}, {}
    for mode in ("flat", "per_leaf"):
        build.reset_launch_counts()
        out[mode] = train.main(argv + ["--local-solver", mode])
        torch.cuda.synchronize()
        grew[mode] = dict(build.launch_counts)
    for a, b in zip(pt.leaves(out["flat"].state.params),
                    pt.leaves(out["per_leaf"].state.params)):
        assert torch.equal(a, b)
    assert grew["flat"]["dane_update_flat"] == 2
    assert grew["per_leaf"]["dane_update_2d"] == 2
    assert not grew["flat"]["dane_update_2d"]
    assert not grew["per_leaf"]["dane_update_flat"]
    assert grew["flat"]["flash_attention"] > 0
    assert grew["flat"]["flash_attention_bwd"] > 0


# ---------------------------------------------------------------------------
# K8, the selective scan
# ---------------------------------------------------------------------------

def _scan_inputs(card, B, S, di, N, seed=40):
    """Scan inputs as the mixer makes them: x of O(1), dt a softplus, b
    and c of O(1), A = -exp(a_log) with a random a_log."""
    x = _normal(seed, (B, S, di), torch.float32, card)
    dt = torch.nn.functional.softplus(
        _normal(seed + 1, (B, S, di), torch.float32, card) - 1.0)
    bc = _normal(seed + 2, (B, S, N), torch.float32, card)
    cc = _normal(seed + 3, (B, S, N), torch.float32, card)
    a = -torch.exp(0.5 * _normal(seed + 4, (di, N), torch.float32, card))
    return x, dt, bc, cc, a


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N", [
    (2, 200, 512, 8),      # the reduced preset at S=200 (not a multiple
                           # of the chunk or the kernel's time tile)
    (1, 64, 8192, 16),     # full width, a short prompt
    (3, 1, 96, 16),        # one step; channels past di in the last block
])
def test_selective_scan_kernel_matches_plain(card, B, S, di, N):
    from repro_torch.kernels.selective_scan import selective_scan
    x, dt, bc, cc, a = _scan_inputs(card, B, S, di, N)
    build.reset_launch_counts()
    got = selective_scan(x, dt, bc, cc, a)
    torch.cuda.synchronize()
    assert build.launch_counts["selective_scan"] == 1
    want = ref.selective_scan_ref(x, dt, bc, cc, a)
    assert got.shape == want.shape and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_selective_scan_kernel_takes_column_views_of_bc_and_cc(card):
    """``Bc`` and ``Cc`` as the mixer hands them over: column slices of
    one (B, S, dt_rank + 2N) product."""
    from repro_torch.kernels.selective_scan import selective_scan
    x, dt, _, _, a = _scan_inputs(card, 2, 100, 128, 8)
    proj = _normal(50, (2, 100, 4 + 16), torch.float32, card)
    bc, cc = proj[..., 4:12], proj[..., 12:]
    got = selective_scan(x, dt, bc, cc, a)
    want = ref.selective_scan_ref(x, dt, bc, cc, a)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
def test_selective_scan_kernel_refuses(card):
    """Another dtype, a grouped A on serving's launch (it takes one A),
    a non-contiguous x and a state size it is not built for raise;
    nothing is launched."""
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_fwd)
    x, dt, bc, cc, a = _scan_inputs(card, 1, 16, 64, 8)
    build.reset_launch_counts()
    with pytest.raises(TypeError, match="float32"):
        selective_scan(x.bfloat16(), dt, bc, cc, a)
    with pytest.raises(TypeError, match="float32"):
        selective_scan(x, dt, bc, cc, a.double())
    with pytest.raises(ValueError, match="grouped A"):
        selective_scan_fwd(x, dt, bc, cc, a[None])
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan(torch.cat([x, x], dim=-1)[..., :64], dt, bc, cc, a)
    x4, dt4, bc4, cc4, a4 = _scan_inputs(card, 1, 16, 64, 4)
    with pytest.raises(ValueError, match="state dim N=4"):
        selective_scan(x4, dt4, bc4, cc4, a4)
    assert build.launch_counts["selective_scan"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [0, 2])
def test_selective_scan_bwd_kernel_matches_plain(card, groups):
    """K8-bwd at the reduced preset's (2, 200, 512) N=8 (S off the chunk),
    A shared or one a batch row (a vmap fold of 2 clients), from the
    states K8's training launch saved, against the plain backward on the
    card: each output within 1e-5 x its max |g|; two calls bitwise
    equal; one count each for the forward and the backward."""
    from repro_torch.kernels.selective_scan import (selective_scan_bwd,
                                                    selective_scan_fwd)
    x, dt, bc, cc, a = _scan_inputs(card, 2, 200, 512, 8)
    if groups:
        a = torch.stack([a, a.flip(0)])
    dy = _normal(60, (2, 200, 512), torch.float32, card)
    build.reset_launch_counts()
    y, H = selective_scan_fwd(x, dt, bc, cc, a, with_states=True)
    got = selective_scan_bwd(x, dt, bc, cc, a, H, dy)
    again = selective_scan_bwd(x, dt, bc, cc, a, H, dy)
    torch.cuda.synchronize()
    assert build.launch_counts["selective_scan"] == 1
    assert build.launch_counts["selective_scan_bwd"] == 2
    y_ref, H_ref = ref.selective_scan_fwd_ref(x, dt, bc, cc, a)
    assert H.shape == H_ref.shape == (2, 4, 512, 8)
    assert float((y - y_ref).abs().max()) <= 1e-5 * float(
        y_ref.abs().max())
    want = ref.selective_scan_bwd_ref(x, dt, bc, cc, a, H_ref, dy)
    for g, w, g2 in zip(got, want, again):
        assert g.shape == w.shape and torch.equal(g, g2)
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.cuda
def test_mamba_mixer_runs_k8_on_the_card(card):
    """The reduced jamba preset's mixer on the card launches K8 once and
    agrees with the same mixer on the plain scan, on the card and on the
    CPU, within 1e-5 x max |out|."""
    from repro_torch.configs import get_arch
    from repro_torch.core import pytree as pt
    from repro_torch.models import param, ssm
    cfg = get_arch("jamba-v0.1-52b").reduced()
    p = param.init_params(ssm.mamba_specs(cfg),
                          torch.Generator().manual_seed(0), device="cpu")
    p["a_log"] = _normal(7, tuple(p["a_log"].shape), torch.float32, "cpu")
    x = _normal(8, (2, 200, cfg.d_model), torch.float32, "cpu")
    pc = pt.tmap(lambda t: t.to(card), p)
    build.reset_launch_counts()
    got = ssm.mamba_mixer(pc, x.to(card), cfg)
    torch.cuda.synchronize()
    assert build.launch_counts["selective_scan"] == 1
    scale = float(got.abs().max())
    saved = ssm.selective_scan
    ssm.selective_scan = ssm.plain_scan
    try:
        plain = ssm.mamba_mixer(pc, x.to(card), cfg)
    finally:
        ssm.selective_scan = saved
    assert build.launch_counts["selective_scan"] == 1
    cpu = ssm.mamba_mixer(p, x, cfg)
    assert float((got - plain).abs().max()) <= 1e-5 * scale
    assert float((got.cpu() - cpu).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# K9 and K10, the xLSTM scans
# ---------------------------------------------------------------------------

def _mlstm_inputs(card, B, S, H, D, seed=60):
    """q, k, v of O(1); log_i of O(1); log_f a log-sigmoid."""
    q, k, v = (_normal(seed + i, (B, S, H, D), torch.float32, card)
               for i in range(3))
    log_i = _normal(seed + 3, (B, S, H), torch.float32, card)
    log_f = ref.logsigmoid(_normal(seed + 4, (B, S, H), torch.float32, card)
                           + 2.0)
    return q, k, v, log_i, log_f


def _slstm_inputs(card, B, S, H, D, seed=70):
    """zx, ix, fx, ox of O(1); the recurrent matrices at scale 0.2 (the
    model's 0.02 would leave the recurrence almost idle)."""
    xs = [_normal(seed + i, (B, S, H, D), torch.float32, card)
          for i in range(4)]
    rs = [0.2 * _normal(seed + 4 + i, (H, D, D), torch.float32, card)
          for i in range(4)]
    return xs + rs


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D", [
    (2, 100, 4, 128),      # the reduced preset, S off the kernel's tile
    (1, 64, 4, 512),       # full width, a short prompt
    (3, 1, 2, 64),         # one step
    (1, 300, 4, 512),      # full width: many staged tiles and a part
])
def test_mlstm_scan_kernel_matches_plain(card, B, S, H, D):
    """K9 against its plain version on the card within 1e-5 x max |h|;
    two calls bitwise equal; one count a call."""
    from repro_torch.kernels.xlstm_scan import mlstm_scan
    args = _mlstm_inputs(card, B, S, H, D)
    build.reset_launch_counts()
    got = mlstm_scan(*args)
    again = mlstm_scan(*args)
    torch.cuda.synchronize()
    assert build.launch_counts["mlstm_scan"] == 2
    assert torch.equal(got, again)
    want = ref.mlstm_scan_ref(*args)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D", [
    (2, 100, 4, 64),       # the reduced preset
    (1, 64, 4, 256),       # full width, a short prompt
    (3, 1, 2, 32),         # one step
    (1, 300, 4, 256),      # full width: the 8-block cluster, many steps
    (2, 64, 4, 128),       # a cluster of 2
])
def test_slstm_scan_kernel_matches_plain(card, B, S, H, D):
    """K10 against its plain version on the card within 1e-5 x max |h|;
    two calls bitwise equal; one count a call."""
    from repro_torch.kernels.xlstm_scan import slstm_scan
    args = _slstm_inputs(card, B, S, H, D)
    build.reset_launch_counts()
    got = slstm_scan(*args)
    again = slstm_scan(*args)
    torch.cuda.synchronize()
    assert build.launch_counts["slstm_scan"] == 2
    assert torch.equal(got, again)
    want = ref.slstm_scan_ref(*args)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["serve", "train", "bwd"])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_slstm_clusters_fit_the_card(card, D, kind):
    """Each K10 launch and K10-bwd, at each head dim, has room for at
    least one of its clusters on the card (a launch refuses where it has
    none)."""
    from repro_torch.kernels.xlstm_scan import slstm_resident_clusters
    assert slstm_resident_clusters(D, kind) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256, 512])
def test_mlstm_bwd_clusters_fit_the_card(card, D):
    """K9-bwd's walk, at each head dim, has room for at least one of its
    plan's clusters on the card (a launch fails where it has none)."""
    from repro_torch.kernels.xlstm_scan import mlstm_resident_clusters
    assert mlstm_resident_clusters(D) >= 1


@pytest.mark.cuda
def test_xlstm_scan_kernels_refuse(card):
    """Another dtype and a head dim they are not built for raise; nothing
    is launched."""
    from repro_torch.kernels.xlstm_scan import mlstm_scan, slstm_scan
    m = _mlstm_inputs(card, 1, 8, 2, 64)
    s = _slstm_inputs(card, 1, 8, 2, 64)
    build.reset_launch_counts()
    with pytest.raises(TypeError, match="float32"):
        mlstm_scan(m[0].double(), *m[1:])
    with pytest.raises(TypeError, match="float32"):
        slstm_scan(*s[:4], s[4].bfloat16(), *s[5:])
    with pytest.raises(ValueError, match="head dim 96"):
        mlstm_scan(*_mlstm_inputs(card, 1, 8, 2, 96))
    with pytest.raises(ValueError, match="head dim 96"):
        slstm_scan(*_slstm_inputs(card, 1, 8, 2, 96))
    assert build.launch_counts["mlstm_scan"] == 0
    assert build.launch_counts["slstm_scan"] == 0


def _rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D", [
    (2, 100, 4, 128),      # the reduced preset, a chunk and a part
    (1, 130, 2, 512),      # full width, three chunks
    (2, 64, 2, 64),        # one whole chunk
    (1, 201, 2, 512),      # a partial chunk and sub-chunk, 8-step plan
    (2, 75, 2, 256),       # a partial chunk and sub-chunk, 16-step plan
])
def test_mlstm_scan_bwd_kernel_matches_plain(card, B, S, H, D):
    """K9's training launch (h and the chunk states) and K9-bwd against
    their plain versions on the card, each output within 1e-5 x its max
    |.| (the states at chunk 0 are exact zeros); K9-bwd's two calls
    bitwise equal; one count a call."""
    from repro_torch.kernels.xlstm_scan import (mlstm_scan_bwd,
                                                mlstm_scan_fwd)
    args = _mlstm_inputs(card, B, S, H, D)
    dh = _normal(80, (B, S, H, D), torch.float32, card)
    build.reset_launch_counts()
    out = mlstm_scan_fwd(*args, with_states=True)
    got = mlstm_scan_bwd(*args, *out, dh)
    again = mlstm_scan_bwd(*args, *out, dh)
    torch.cuda.synchronize()
    assert build.launch_counts["mlstm_scan"] == 1
    assert build.launch_counts["mlstm_scan_bwd"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want_out = ref.mlstm_scan_fwd_ref(*args)
    for a, b in zip(out[:3], want_out[:3]):
        assert _rel_err(a, b) <= 1e-5
    assert torch.equal(out[3][:, 0], want_out[3][:, 0])
    want = ref.mlstm_scan_bwd_ref(*args, *out, dh)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel_err(a, b) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,G", [
    (2, 100, 4, 64, 0),    # the reduced preset
    (1, 64, 4, 256, 0),    # full width
    (4, 30, 2, 32, 2),     # a vmap fold of 2 clients, r in 2 groups
    (4, 64, 4, 256, 2),    # the fold at full width: 8-block clusters
])
def test_slstm_scan_bwd_kernel_matches_plain(card, B, S, H, D, G):
    """K10's training launch (h and every step's states, r in G groups)
    and K10-bwd against their plain versions on the card, each output
    within 1e-5 x its max |.|; K10-bwd's two calls bitwise equal; one
    count a call."""
    from repro_torch.kernels.xlstm_scan import (slstm_scan_bwd,
                                                slstm_scan_fwd)
    args = _slstm_inputs(card, B, S, H, D)
    if G:
        args = args[:4] + [torch.stack([r, 0.5 * r]) for r in args[4:]]
    dh = _normal(81, (B, S, H, D), torch.float32, card)
    build.reset_launch_counts()
    out = slstm_scan_fwd(*args, with_states=True)
    got = slstm_scan_bwd(*args[4:], *out, dh)
    again = slstm_scan_bwd(*args[4:], *out, dh)
    torch.cuda.synchronize()
    assert build.launch_counts["slstm_scan"] == 1
    assert build.launch_counts["slstm_scan_bwd"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(out, ref.slstm_scan_fwd_ref(*args)):
        assert _rel_err(a, b) <= 1e-5
    want = ref.slstm_scan_bwd_ref(*args[4:], *out, dh)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel_err(a, b) <= 1e-5


@pytest.mark.cuda
def test_xlstm_train_step_runs_the_backward_kernels_on_the_card(card):
    """The reduced xlstm-350m preset's fedavg step on the card launches
    K9 and K10 once and K9-bwd and K10-bwd once a layer of each kind
    (remat none) and its new params agree with the CPU path's within
    1e-4 x eta max |g| of each leaf (plus 1e-7, an ulp of the params)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import pytree as pt
    from repro_torch.launch import steps
    from repro_torch.models import param, transformer
    cfg = get_arch("xlstm-350m").reduced()
    p = param.init_params(transformer.model_specs(cfg),
                          torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(4)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 100))
                             .astype(np.int32)) for k in ("tokens",
                                                          "labels")}
    step = steps.make_fedavg_step(cfg, eta=0.05, remat="none")
    build.reset_launch_counts()
    got, _ = step({"params": pt.tmap(lambda t: t.to(card), p)},
                  {k: v.to(card) for k, v in b.items()})
    torch.cuda.synchronize()
    layers = cfg.num_layers // 2
    for name in ("mlstm_scan", "slstm_scan", "mlstm_scan_bwd",
                 "slstm_scan_bwd"):
        assert build.launch_counts[name] == layers, name
    want, _ = step({"params": p}, b)
    for a, c, w in zip(pt.leaves(got["params"]), pt.leaves(p),
                       pt.leaves(want["params"])):
        moved = float((w - c).abs().max())       # eta x max |g|
        assert float((a.cpu() - w).abs().max()) <= 1e-4 * moved + 1e-7


@pytest.mark.cuda
def test_xlstm_model_runs_k9_and_k10_on_the_card(card):
    """The reduced xlstm-350m preset's prefill on the card launches K9
    and K10 once a layer of each kind and agrees with the CPU path within
    1e-4 x max |logit|; its serve loop launches neither and gives the CPU
    path's tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.core import pytree as pt
    from repro_torch.launch import serve
    from repro_torch.models import param, transformer
    cfg = get_arch("xlstm-350m").reduced()
    p = param.init_params(transformer.model_specs(cfg),
                          torch.Generator().manual_seed(0), device="cpu")
    pc = pt.tmap(lambda t: t.to(card), p)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    build.reset_launch_counts()
    got = transformer.prefill(pc, {"tokens": toks.to(card)}, cfg)
    torch.cuda.synchronize()
    layers = cfg.num_layers // 2
    assert build.launch_counts["mlstm_scan"] == layers
    assert build.launch_counts["slstm_scan"] == layers
    want = transformer.prefill(p, {"tokens": toks}, cfg)
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    build.reset_launch_counts()
    gen = serve.generate(pc, cfg, toks[:, :6].to(card), 4, 16)
    assert set(build.launch_counts.values()) == {0}
    assert torch.equal(gen.tokens.cpu(),
                       serve.generate(p, cfg, toks[:, :6], 4, 16).tokens)


def _whisper(card):
    """The reduced whisper-tiny preset (2 + 2 layers, d=256), weights
    from seed 0 on the CPU and the card, and a numpy-seeded batch of 2 x
    40 tokens and labels with 2 x 60 random frames."""
    from repro_torch.configs import get_arch
    from repro_torch.core import pytree as pt
    from repro_torch.models import param, transformer
    cfg = get_arch("whisper-tiny").reduced()
    p = param.init_params(transformer.model_specs(cfg),
                          torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(6)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40))
                             .astype(np.int32)) for k in ("tokens",
                                                          "labels")}
    b["frames"] = torch.from_numpy(
        rng.normal(size=(2, 60, cfg.d_model)).astype(np.float32))
    return (cfg, p, pt.tmap(lambda t: t.to(card), p), b,
            {k: v.to(card) for k, v in b.items()})


@pytest.mark.cuda
def test_whisper_model_runs_k7_on_the_card(card):
    """The reduced whisper-tiny's prefill (60 frames, one token) launches
    K7 once an attention (2 encoder, 2 decoder self, 2 cross) and agrees
    with the CPU path within 1e-4 x max |logit|; ``serve.generate`` with
    the frames launches K7 once an encoder layer (the cross caches) and
    gives the CPU path's tokens."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg, p, pc, b, bc = _whisper(card)
    batch = {"frames": bc["frames"], "tokens": bc["tokens"][:, :1]}
    build.reset_launch_counts()
    got = transformer.prefill(pc, batch, cfg)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_attention"] == \
        cfg.num_encoder_layers + 2 * cfg.num_layers
    want = transformer.prefill(p, {"frames": b["frames"],
                                   "tokens": b["tokens"][:, :1]}, cfg)
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    build.reset_launch_counts()
    gen = serve.generate(pc, cfg, bc["tokens"][:, :6], 4, 16,
                         frames=bc["frames"])
    assert build.launch_counts["flash_attention"] == cfg.num_encoder_layers
    assert torch.equal(gen.tokens.cpu(), serve.generate(
        p, cfg, b["tokens"][:, :6], 4, 16, frames=b["frames"]).tokens)


@pytest.mark.cuda
def test_whisper_train_step_runs_k7_bwd_on_the_card(card):
    """The reduced whisper-tiny's fedavg step (remat none, 40 tokens
    against 60 frames) launches K7 and K7-bwd once an attention, and its
    new params agree with the CPU path's within 1e-4 x eta max |g| of
    each leaf (plus 1e-7, an ulp of the params)."""
    from repro_torch.core import pytree as pt
    from repro_torch.launch import steps
    cfg, p, pc, b, bc = _whisper(card)
    step = steps.make_fedavg_step(cfg, eta=0.05, remat="none")
    build.reset_launch_counts()
    got, _ = step({"params": pc}, bc)
    torch.cuda.synchronize()
    n = cfg.num_encoder_layers + 2 * cfg.num_layers
    assert build.launch_counts["flash_attention"] == n
    assert build.launch_counts["flash_attention_bwd"] == n
    want, _ = step({"params": p}, b)
    for a, c, w in zip(pt.leaves(got["params"]), pt.leaves(p),
                       pt.leaves(want["params"])):
        moved = float((w - c).abs().max())       # eta x max |g|
        assert float((a.cpu() - w).abs().max()) <= 1e-4 * moved + 1e-7
