"""The port's kernel layer against the JAX package's Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels`` takes its kernel's
plain PyTorch version; here those plain versions are held against the
reference kernels run in interpret mode (as tests/test_kernels.py runs
them), on the same numpy-seeded inputs.  The CUDA kernels themselves
are held against the same plain versions on the card by chip_smoke.py.

Tolerances:
- the update (K1, K4): the port rounds op by op, while XLA:CPU may
  contract ``w - eta * (...)`` into a fused multiply-add, so the two
  differ by an ulp on some elements: atol 1e-6 on O(1) values.  Inside
  the port, flat and per-leaf stay bitwise equal;
- the fused local solve (K2, K3) sums its dot products in another order
  than XLA: atol 1e-6 on O(1) weights after a handful of steps;
- the codec aggregate (K5) sums the cohort in client order, as XLA:CPU
  does, but may round ``sum / count`` differently: rtol/atol 1e-6, the
  reference's own bar for its kernel (tests/test_codecs.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.kernels import codec as jcodec
from repro.kernels import flatpack as jflat
from repro.kernels import local_solve as jls
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import pytree as pt
from repro_torch.kernels import build, codec, flatpack, local_solve, ops, ref

UPDATE_ATOL = 1e-6
SOLVE_ATOL = 1e-6
CODEC_TOL = 1e-6


def _np(seed, *shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("eta,mu", [(0.01, 0.0), (0.1, 1.0), (1e-3, 0.01)])
def test_dane_update_flat_matches_reference(eta, mu):
    """K1: masked flat-pack update, a masked device keeps w."""
    k, rows = 5, 8
    w, g, c, a = _np(0, *[(k * rows, 128)] * 4)
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    want = jops.dane_update_flat_masked(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(c), jnp.asarray(a),
        eta, mu, jnp.asarray(mask), rows, interpret=True)
    got = ops.dane_update_flat_masked(_t(w), _t(g), _t(c), _t(a), eta, mu,
                                      _t(mask), rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=UPDATE_ATOL)
    np.testing.assert_array_equal(got.numpy()[rows:2 * rows],
                                  w[rows:2 * rows])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_dane_update_masked_matches_reference(dtype):
    """K4 per leaf (one launch per leaf) plus the select."""
    k = 4
    shapes = {"w": (k, 60, 10), "b": (k, 10)}
    trees = [dict(zip(shapes, _np(i, *shapes.values()))) for i in range(4)]
    valid = np.array([1, 1, 0, 1], np.float32)
    if dtype == "bfloat16":
        jt = [jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.bfloat16), t) for t in trees]
        tt = [pt.tmap(lambda x: _t(x).to(torch.bfloat16), t)
              for t in trees]
    else:
        jt = [_jtree(t) for t in trees]
        tt = [pt.tmap(_t, t) for t in trees]
    want = jops.dane_update_masked(*jt, 0.05, 0.1, jnp.asarray(valid),
                                   interpret=True)
    got = ops.dane_update_masked(*tt, 0.05, 0.1, _t(valid))
    for name in shapes:
        np.testing.assert_allclose(
            got[name].float().numpy(),
            np.asarray(want[name].astype(jnp.float32)), rtol=0,
            atol=UPDATE_ATOL)
        np.testing.assert_array_equal(got[name][2].float().numpy(),
                                      np.asarray(jt[0][name][2],
                                                 np.float32))


def test_tree_flat_equals_per_leaf_bitwise():
    """Inside the port the flat pack is pure layout: K1 over the packed
    tree equals K4 per leaf bitwise, masked devices included."""
    k = 3
    shapes = {"w": (k, 60, 10), "b": (k, 10)}
    trees = [{n: _t(x) for n, x in zip(shapes, _np(i, *shapes.values()))}
             for i in range(4)]
    valid = _t(np.array([1, 0, 1], np.float32))
    flat = ops.dane_update_tree_masked(*trees, 0.05, 0.01, valid)
    leaf = ops.dane_update_masked(*trees, 0.05, 0.01, valid)
    for name in shapes:
        assert torch.equal(flat[name], leaf[name])


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_dane_update_leaves_matches_reference(dtype, masked):
    """The per_leaf step's one-launch wrapper (its plain version on the
    CPU) against the reference's per-leaf kernels in interpret mode, on
    leaves whose sizes are not multiples of 4 or of 128; a masked device
    keeps w bitwise."""
    from repro_torch.kernels.dane_update import dane_update_leaves
    k = 4
    shapes = {"w": (k, 61, 7), "b": (k, 3), "v": (k, 1)}
    trees = [dict(zip(shapes, _np(10 + i, *shapes.values())))
             for i in range(4)]
    valid = np.array([1, 0, 1, 1], np.float32)
    if dtype == "bfloat16":
        jt = [jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.bfloat16), t) for t in trees]
        tt = [pt.tmap(lambda x: _t(x).to(torch.bfloat16), t)
              for t in trees]
    else:
        jt = [_jtree(t) for t in trees]
        tt = [pt.tmap(_t, t) for t in trees]
    if masked:
        want = jops.dane_update_masked(*jt, 0.05, 0.1, jnp.asarray(valid),
                                       interpret=True)
    else:
        want = jops.dane_update(*jt, 0.05, 0.1, interpret=True)
    got = dane_update_leaves(*(pt.leaves(t) for t in tt), 0.05, 0.1,
                             _t(valid) if masked else None)
    for name, leaf in zip(sorted(shapes), got):
        assert leaf.dtype == tt[0][name].dtype
        np.testing.assert_allclose(
            leaf.float().numpy(),
            np.asarray(want[name].astype(jnp.float32)), rtol=0,
            atol=UPDATE_ATOL)
        if masked:
            assert torch.equal(leaf[1], tt[0][name][1])


def _pack_every_step(spec, k, w, grads, corr, w0, eta, mu, masks):
    """The flat step as it was written before ``ops.FlatUpdate``: pack w
    and g anew each step, one K1 launch, unpack."""
    corr_f = flatpack.pack_stacked(spec, corr, k)
    anchor_f = flatpack.pack_broadcast(spec, w0, k)
    for g_of, m in zip(grads, masks):
        wf = ops.dane_update_flat_masked(
            flatpack.pack_stacked(spec, w, k),
            flatpack.pack_stacked(spec, g_of(w), k), corr_f, anchor_f, eta,
            mu, m, spec.rows)
        w = flatpack.unpack_stacked(spec, wf, k)
    return w


@pytest.mark.parametrize("bf16", [False, True])
def test_flat_update_equals_packing_every_step(bf16):
    """``ops.FlatUpdate`` keeps w packed across steps and packs only g:
    bitwise equal to packing w and g anew each step, over 5 masked steps
    of a tree with (with ``bf16``) a bfloat16 leaf, whose rounding the
    kept pack must carry; a step's tree stays valid through the next
    step."""
    k = 3
    leaf_dt = {"w": torch.float32,
               "b": torch.bfloat16 if bf16 else torch.float32,
               "z": torch.float32}
    w0 = {n: _t(x).to(leaf_dt[n]) for n, x in
          zip(("w", "b", "z"), _np(20, (60, 10), (10,), (3, 5)))}
    corr = {n: _t(x).to(leaf_dt[n]) for n, x in
            zip(("w", "b", "z"), _np(21, (k, 60, 10), (k, 10), (k, 3, 5)))}
    spec = flatpack.flat_spec(w0)
    masks = [_t(np.array(m, np.float32)) for m in
             ([1, 1, 1], [1, 0, 1], [0, 0, 0], [1, 1, 0], [1, 1, 1])]

    def g_of(w):                  # a gradient that depends on w
        return pt.tmap(lambda x: (torch.sin(x.float()) * 0.3).to(x.dtype),
                       w)

    anchor = pt.tmap(lambda x: x.expand((k,) + x.shape).contiguous(), w0)
    want = _pack_every_step(spec, k, anchor, [g_of] * 5, corr, w0, 0.05,
                            0.2, masks)
    upd = ops.FlatUpdate(spec, corr, w0, k)
    w, prev = anchor, None
    for m in masks:
        w_next = upd.step(g_of(w), 0.05, 0.2, m)
        if prev is not None:
            for a, b in zip(pt.leaves(w), prev):
                assert torch.equal(a, b)
        w, prev = w_next, [x.clone() for x in pt.leaves(w_next)]
    for name in w0:
        assert w[name].dtype == leaf_dt[name]
        assert torch.equal(w[name], want[name])


@pytest.mark.parametrize("cutoff", [False, True])
def test_flat_solver_keeps_w_packed_bitwise(cutoff):
    """The flat solver mode (w kept packed) equals the per_leaf mode and
    the pack-every-step loop bitwise over E=2 epochs, K=3 devices (one
    with a padding batch, one masked out), with and without a step
    cap."""
    from repro_torch.core import client
    from repro_torch.models import small

    K, nb, B, d, C, E, eta, mu = 3, 3, 10, 60, 10, 2, 0.01, 0.001
    rng = np.random.default_rng(5)
    x = _t(rng.normal(size=(K, nb, B, d)).astype(np.float32))
    y = _t(rng.integers(0, C, (K, nb, B)).astype(np.int32))
    w0 = {"w": _t((0.1 * rng.normal(size=(d, C))).astype(np.float32)),
          "b": _t((0.1 * rng.normal(size=C)).astype(np.float32))}
    corr = {"w": _t((0.01 * rng.normal(size=(K, d, C))).astype(np.float32)),
            "b": _t((0.01 * rng.normal(size=(K, C))).astype(np.float32))}
    valid = _t(np.array([[1, 1, 1], [1, 1, 0], [0, 0, 0]], np.float32))
    limit = _t(np.array([4, 2, 3], np.float32)) if cutoff else None
    args = (w0, corr, mu, {"x": x, "y": y}, valid) + \
        ((limit,) if cutoff else ())
    got = {mode: client.make_batched_solver(
        small.logreg_loss, learning_rate=eta, num_epochs=E,
        with_cutoff=cutoff, solver=mode)(*args)
        for mode in ("flat", "per_leaf")}

    grad_fn = torch.func.vmap(torch.func.grad(small.logreg_loss))
    grads, masks, so_far = [], [], torch.zeros(K)
    for _ in range(E):
        for j in range(nb):
            batch = {"x": x[:, j], "y": y[:, j]}
            grads.append(lambda w, batch=batch: grad_fn(w, batch))
            v = valid[:, j]
            masks.append(v if limit is None else v * (so_far < limit))
            so_far = so_far + v
    anchor = pt.tmap(lambda a: a.expand((K,) + a.shape).contiguous(), w0)
    want = _pack_every_step(flatpack.flat_spec(w0), K, anchor, grads, corr,
                            w0, eta, mu, masks)
    for name in ("w", "b"):
        assert torch.equal(got["flat"].params[name], want[name])
        assert torch.equal(got["per_leaf"].params[name], want[name])
    assert torch.equal(got["flat"].params["w"][2], anchor["w"][2])


_W = torch.zeros(2, 5, 3)


@pytest.mark.parametrize("args,err,match", [
    (dict(g=[torch.zeros(2, 5, 4)]), ValueError, "differ"),
    (dict(c=[torch.zeros(2, 5, 3, dtype=torch.float64)]), ValueError,
     "differ"),
    (dict(w=[_W.half()], g=[_W.half()], c=[_W.half()], a=[_W.half()]),
     TypeError, "dtype"),
    (dict(a=[torch.zeros(2, 5, 3, device="meta")]), ValueError, "differ"),
    (dict(w=[_W.to("meta")], g=[_W.to("meta")], c=[_W.to("meta")],
          a=[_W.to("meta")]), ValueError, "on meta"),
    (dict(mask=torch.ones(3)), ValueError, "mask shape"),
    (dict(mask=torch.ones(2, 1)), ValueError, "mask shape"),
    (dict(g=[_W, _W]), ValueError, "leaves"),
    (dict(w=[_W, torch.zeros(3, 5)], g=[_W, torch.zeros(3, 5)],
          c=[_W, torch.zeros(3, 5)], a=[_W, torch.zeros(3, 5)]),
     ValueError, "leading axis"),
])
def test_dane_update_leaves_checks_its_inputs(args, err, match):
    from repro_torch.kernels.dane_update import dane_update_leaves
    kw = dict(w=[_W], g=[_W], c=[_W], a=[_W], mask=torch.ones(2))
    kw.update(args)
    with pytest.raises(err, match=match) as e:
        dane_update_leaves(kw["w"], kw["g"], kw["c"], kw["a"], 0.1, 0.0,
                           kw["mask"])
    assert str(e.value).startswith("dane_update_leaves: ")


def test_update_wrappers_take_any_layout_on_cpu_and_check_out():
    """On the CPU the plain versions take strided operands, as before the
    segment kernel (contiguity is a rule of the card only), and give the
    contiguous copies' bits."""
    from repro_torch.kernels import dane_update
    gen = torch.Generator().manual_seed(3)
    w, g, c, a = (torch.randn(16, 128, generator=gen) for _ in range(4))
    t = torch.randn(128, 16, generator=gen).t()
    mask = torch.tensor([1.0, 0.0])
    assert torch.equal(dane_update.dane_update_2d(w, g, c, t, 0.1, 0.3),
                       dane_update.dane_update_2d(w, g, c, t.contiguous(),
                                                  0.1, 0.3))
    assert torch.equal(
        dane_update.dane_update_flat(t, g, c, a, 0.1, 0.3, mask, 8),
        dane_update.dane_update_flat(t.contiguous(), g, c, a, 0.1, 0.3,
                                     mask, 8))
    lt = torch.randn(2, 128, 8, generator=gen).transpose(1, 2)
    g, c, a = (x.view(2, 8, 128) for x in (g, c, a))
    got = dane_update.dane_update_leaves([lt], [g], [c], [a], 0.1, 0.3, mask)
    want = dane_update.dane_update_leaves([lt.contiguous()], [g], [c], [a],
                                          0.1, 0.3, mask)
    assert torch.equal(got[0], want[0])
    w = torch.zeros(16, 128)
    with pytest.raises(ValueError, match="out must be"):
        dane_update.dane_update_flat(w, w, w, w, 0.1, 0.0, torch.ones(2), 8,
                                     out=torch.zeros(8, 128))
    out = torch.full((16, 128), 7.0)
    got = dane_update.dane_update_flat(w + 1, w, w, w, 0.5, 0.0,
                                       torch.ones(2), 8, out=out)
    assert got is out and bool((out == 1.0).all())


def test_flatpack_layout_matches_reference():
    k = 3
    tree = {"w": _np(1, (k, 60, 10))[0], "b": _np(2, (k, 10))[0]}
    jspec = jflat.flat_spec(jax.tree_util.tree_map(lambda x: x[0],
                                                   _jtree(tree)))
    spec = flatpack.flat_spec(pt.index(pt.tmap(_t, tree), 0))
    assert (spec.rows, spec.total, spec.offsets) == \
        (jspec.rows, jspec.total, jspec.offsets)
    want = jflat.pack_stacked(jspec, _jtree(tree), k)
    got = flatpack.pack_stacked(spec, pt.tmap(_t, tree), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = flatpack.unpack_stacked(spec, got, k)
    for name in tree:
        np.testing.assert_array_equal(back[name].numpy(), tree[name])


def _logreg_inputs(seed, K, nb, B, d, C):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(K, nb, B, d)).astype(np.float32)
    y = rng.integers(0, C, size=(K, nb, B)).astype(np.int32)
    w0 = {"w": (0.1 * rng.normal(size=(d, C))).astype(np.float32),
          "b": (0.1 * rng.normal(size=(C,))).astype(np.float32)}
    corr = {"w": (0.01 * rng.normal(size=(K, d, C))).astype(np.float32),
            "b": (0.01 * rng.normal(size=(K, C))).astype(np.float32)}
    return x, y, w0, corr


def test_local_epoch_matches_reference():
    """K2: whole E-epoch solve; the step mask holds padding zeros (a
    device with fewer batches) and a fully masked device."""
    K, nb, B, d, C, E = 3, 4, 5, 7, 4, 2
    x, y, w0, corr = _logreg_inputs(3, K, nb, B, d, C)
    valid = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [0, 0, 0, 0]],
                     np.float32)
    mask = np.tile(valid, (1, E))
    want = jls.local_epoch(_jtree(w0), _jtree(corr),
                           {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                           eta=0.1, mu=0.05, num_epochs=E,
                           step_mask=jnp.asarray(mask), interpret=True)
    got = local_solve.local_epoch(
        pt.tmap(_t, w0), pt.tmap(_t, corr), {"x": _t(x), "y": _t(y)},
        eta=0.1, mu=0.05, num_epochs=E, step_mask=_t(mask))
    for name in ("w", "b"):
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]), atol=SOLVE_ATOL)
    # the fully masked device never moves from the anchor
    np.testing.assert_array_equal(got["w"][2].numpy(), w0["w"])


def test_linear_logistic_step_matches_reference():
    """K3: one step, B=10 not a multiple of the reference's row block
    (block_b=4 -> five 2-row blocks), one masked device."""
    K, B, d, C = 3, 10, 7, 4
    x, y, w0, corr = _logreg_inputs(4, K, 1, B, d, C)
    x, y = x[:, 0], y[:, 0]
    rng = np.random.default_rng(5)
    w = {"w": rng.normal(size=(K, d, C)).astype(np.float32),
         "b": rng.normal(size=(K, C)).astype(np.float32)}
    mask = np.array([1, 0, 1], np.float32)
    want = jls.linear_logistic_step(
        _jtree(w), {"x": jnp.asarray(x), "y": jnp.asarray(y)},
        _jtree(corr), _jtree(w0), eta=0.1, mu=0.05,
        mask=jnp.asarray(mask), block_b=4, interpret=True)
    got = local_solve.linear_logistic_step(
        pt.tmap(_t, w), {"x": _t(x), "y": _t(y)}, pt.tmap(_t, corr),
        pt.tmap(_t, w0), eta=0.1, mu=0.05, mask=_t(mask))
    for name in ("w", "b"):
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]), atol=SOLVE_ATOL)
        np.testing.assert_array_equal(got[name][1].numpy(), w[name][1])


@pytest.mark.parametrize("d,nb,epochs,want", [
    (60, 128, 20, "fused_epoch"),     # synthetic(1,1): E*nb = 2560
    (784, 64, 20, "fused_epoch"),     # FEMNIST-like, largest client
    (784, 512, 20, "fused_step"),     # a 5000-sample client
    (60, 128, 40, "fused_step"),
])
def test_select_matches_reference_modes(d, nb, epochs, want):
    """The port's gate (shared-memory budget + the 4096-step rule) picks
    the reference's fused mode at the paper's shapes."""
    w0 = {"w": torch.zeros(d, 10), "b": torch.zeros(10)}
    batches = {"x": torch.zeros(2, nb, 10, d),
               "y": torch.zeros(2, nb, 10, dtype=torch.int32)}
    jw0 = {"w": jnp.zeros((d, 10)), "b": jnp.zeros(10)}
    jb = {"x": jnp.zeros((2, nb, 10, d)),
          "y": jnp.zeros((2, nb, 10), jnp.int32)}
    assert local_solve._select(w0, batches, epochs) == want
    assert jls._select(jw0, jb, epochs) == want


def test_select_takes_the_step_kernel_where_only_it_fits():
    """Where K2's state outgrows one block's shared memory, the gate still
    picks the reference's mode -- the whole-epoch kernel -- and K2 runs
    its global tier (w, the correction and the anchor in global memory)
    rather than giving the workload to the step kernel.  (The name is
    kept from when the step kernel took these shapes.)"""
    d, nb, B = 1500, 10, 10
    assert local_solve.epoch_tier(d, 10, B) == "global"
    assert local_solve.epoch_tier(1030, 10, B) == "shared"
    w0 = {"w": torch.zeros(d, 10), "b": torch.zeros(10)}
    batches = {"x": torch.zeros(2, nb, B, d),
               "y": torch.zeros(2, nb, B, dtype=torch.int32)}
    assert local_solve._select(w0, batches, 2) == "fused_epoch"


def test_select_rejects_what_the_kernels_cannot_take():
    w0 = {"w": torch.zeros(60, 10), "b": torch.zeros(10)}
    x = torch.zeros(2, 4, 10, 60)
    assert local_solve._select(
        w0, {"x": x, "y": x[..., 0]}, 2) is None          # float labels
    assert local_solve._select(
        {"w": w0["w"]}, {"x": x, "y": x[..., 0].int()}, 2) is None
    big = {"w": torch.zeros(8000, 10), "b": torch.zeros(10)}
    assert local_solve._select(
        big, {"x": torch.zeros(1, 1, 10, 8000),
              "y": torch.zeros(1, 1, 10, dtype=torch.int32)},
        2) == "fused_epoch"                        # within the reference's
    over = {"w": torch.zeros(34953, 10), "b": torch.zeros(10)}  # budget
    assert local_solve._select(
        over, {"x": torch.zeros(1, 1, 10, 34953),
               "y": torch.zeros(1, 1, 10, dtype=torch.int32)}, 2) is None


@pytest.mark.parametrize("d,C,B,epochs,nb", [
    (60, 10, 10, 20, 128),        # the paper's synthetic(1,1)
    (784, 10, 10, 20, 64),        # FEMNIST-like
    (1031, 10, 10, 20, 5),        # past K2's shared tier
    (2899, 10, 10, 20, 5),
    (2900, 10, 10, 20, 5),        # past the old step kernel's
    (34952, 10, 10, 2, 5),        # the largest d the budget takes
    (784, 62, 10, 20, 64),        # LEAF FEMNIST's 62 classes
    (3000, 10, 32, 2, 5),
    (34953, 10, 10, 2, 5),        # over the budget: no fused solver
    (60, 10, 10, 32, 128),        # E*nb = 4096: the whole-epoch kernel
    (60, 10, 10, 17, 241),        # E*nb = 4097: the step kernel
])
def test_select_equals_reference_gate(d, C, B, epochs, nb):
    """The port's gate is the reference's, word for word: the same mode
    (or none) at every shape, whatever shared memory holds."""
    w0 = {"w": torch.zeros(d, C, device="meta"),
          "b": torch.zeros(C, device="meta")}
    batches = {"x": torch.zeros(2, nb, B, d, device="meta"),
               "y": torch.zeros(2, nb, B, dtype=torch.int32,
                                device="meta")}
    jw0 = {"w": jax.ShapeDtypeStruct((d, C), jnp.float32),
           "b": jax.ShapeDtypeStruct((C,), jnp.float32)}
    jb = {"x": jax.ShapeDtypeStruct((2, nb, B, d), jnp.float32),
          "y": jax.ShapeDtypeStruct((2, nb, B), jnp.int32)}
    assert local_solve._select(w0, batches, epochs) == \
        jls._select(jw0, jb, epochs)


@pytest.mark.parametrize("mode", ["fused_epoch", "fused_step"])
@pytest.mark.parametrize("d", [3000, 34952])
def test_batched_solver_fuses_past_shared_memory(d, mode):
    """The explicit fused modes resolve and run at sizes past one block's
    shared memory, as in the reference: the port's batched solver (plain
    versions on the CPU) against the reference's (Pallas kernels in
    interpret mode), K=3 devices, one masked, one with a padding batch."""
    from repro.core import client as jclient
    from repro.models import small as jsmall
    from repro_torch.core import client
    from repro_torch.models import small

    K, nb, B, C, E, eta, mu = 3, 2, 10, 10, 2, 0.01, 0.001
    rng = np.random.default_rng(d)
    x = rng.uniform(0.0, 1.0, (K, nb, B, d)).astype(np.float32)
    y = rng.integers(0, C, (K, nb, B)).astype(np.int32)
    w0 = {"w": (0.01 * rng.normal(size=(d, C))).astype(np.float32),
          "b": (0.01 * rng.normal(size=C)).astype(np.float32)}
    corr = {"w": (0.001 * rng.normal(size=(K, d, C))).astype(np.float32),
            "b": (0.001 * rng.normal(size=(K, C))).astype(np.float32)}
    valid = np.array([[1, 1], [1, 0], [0, 0]], np.float32)
    want = jclient.make_batched_solver(
        jsmall.logreg_loss, learning_rate=eta, num_epochs=E,
        solver=mode)(_jtree(w0), _jtree(corr), mu,
                     {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                     jnp.asarray(valid))
    got = client.make_batched_solver(
        small.logreg_loss, learning_rate=eta, num_epochs=E,
        solver=mode)(pt.tmap(_t, w0), pt.tmap(_t, corr), mu,
                     {"x": _t(x), "y": _t(y)}, _t(valid))
    for name in ("w", "b"):
        np.testing.assert_allclose(got.params[name].numpy(),
                                   np.asarray(want.params[name]), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(got.num_steps.numpy(),
                                  np.asarray(want.num_steps))
    np.testing.assert_array_equal(got.params["w"][2].numpy(), w0["w"])


def test_wrappers_check_their_inputs():
    w = torch.zeros(16, 128)
    with pytest.raises(ValueError, match="differ"):
        ops.dane_update_flat_masked(w, w, w, torch.zeros(8, 128), 0.1, 0.0,
                                    torch.ones(2), 8)
    with pytest.raises(ValueError, match="mask shape"):
        ops.dane_update_flat_masked(w, w, w, w, 0.1, 0.0, torch.ones(3), 8)
    with pytest.raises(TypeError, match="dtype"):
        h = w.half()
        ops.dane_update_flat_masked(h, h, h, h, 0.1, 0.0, torch.ones(2), 8)
    with pytest.raises(ValueError, match="rows"):
        ops.dane_update_flat_masked(w, w, w, w, 0.1, 0.0, torch.ones(2), 5)


@pytest.mark.parametrize("k,rows", [(1, 8), (4, 8), (10, 64)])
def test_codec_aggregate_matches_reference(k, rows):
    """K5 against the reference's plain version and its Pallas kernel in
    interpret mode, with random scales and a random mask."""
    rng = np.random.default_rng(k * 100 + rows)
    vals = rng.standard_normal((k, rows, 128)).astype(np.float32)
    scales = rng.uniform(0.5, 2.0, (k,)).astype(np.float32)
    mask = rng.integers(0, 2, (k,)).astype(np.float32)
    mask[0] = 1.0
    got = codec.codec_aggregate(_t(vals), _t(scales), _t(mask)).numpy()
    for want in (jref.codec_aggregate_ref(jnp.asarray(vals),
                                          jnp.asarray(scales),
                                          jnp.asarray(mask)),
                 jcodec.codec_aggregate(jnp.asarray(vals),
                                        jnp.asarray(scales),
                                        jnp.asarray(mask), interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=CODEC_TOL,
                                   atol=CODEC_TOL)


@pytest.mark.parametrize("partial", [False, True])
def test_codec_aggregate_at_most_clients_matches_reference(partial):
    """K5 and K6 at the most clients one launch takes (K=1,024) with a
    sparse mask, about one client in twenty active: the plain versions
    against the reference's Pallas kernels in interpret mode."""
    k, rows = codec.MAX_CLIENTS, 8
    rng = np.random.default_rng(1024)
    vals = rng.standard_normal((k, rows, 128)).astype(np.float32)
    scales = rng.uniform(0.5, 2.0, (k,)).astype(np.float32)
    mask = (rng.uniform(size=k) < 0.05).astype(np.float32)
    assert 0 < mask.sum() < k / 10
    fn, jfn = ((codec.codec_aggregate_partial, jcodec.codec_aggregate_partial)
               if partial else (codec.codec_aggregate, jcodec.codec_aggregate))
    got = fn(_t(vals), _t(scales), _t(mask)).numpy()
    want = np.asarray(jfn(jnp.asarray(vals), jnp.asarray(scales),
                          jnp.asarray(mask), interpret=True))
    # The port adds the n active clients in order, the reference reduces
    # all K in XLA's order: two float32 sums of n terms differ by at most
    # 2 n u sum |term| (u = 2^-24, a contracted product included), which
    # at n ~ 50 exceeds CODEC_TOL; the mean's division rounds once more
    # on each side (one ulp, <= 2^-23 |x|).
    n = int(mask.sum())
    terms = np.abs(vals.astype(np.float64)
                   * (scales * mask)[:, None, None]).sum(axis=0)
    bound = 2 * n * 2.0 ** -24 * terms
    if not partial:
        bound = bound / n + 2.0 ** -23 * np.abs(want)
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)


def test_codec_aggregate_all_inactive_is_zero():
    vals = torch.ones(3, 8, 128)
    out = codec.codec_aggregate(vals, torch.ones(3), torch.zeros(3))
    assert torch.equal(out, torch.zeros(8, 128))
    want = jcodec.codec_aggregate(jnp.ones((3, 8, 128)), jnp.ones((3,)),
                                  jnp.zeros((3,)), interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_codec_aggregate_ref_skips_masked_clients():
    """The plain version (and so the kernel) adds the active clients in
    order and never reads a masked one: a masked client's non-finite
    slab leaves the aggregate finite and unchanged."""
    rng = np.random.default_rng(5)
    vals = _t(rng.standard_normal((3, 8, 128)).astype(np.float32))
    scales = torch.tensor([0.5, 2.0, 1.5])
    mask = torch.tensor([1.0, 0.0, 1.0])
    clean = ref.codec_aggregate_ref(vals, scales, mask)
    vals[1] = float("nan")
    assert torch.equal(ref.codec_aggregate_ref(vals, scales, mask), clean)
    manual = (vals[0] * (scales[0] * mask[0]) + vals[2]
              * (scales[2] * mask[2])) / torch.tensor(2.0)
    assert torch.equal(clean, manual)


@pytest.mark.parametrize("bad,err,match", [
    (dict(vals=torch.zeros(2, 8, 64)), ValueError, r"\(K, rows, 128\)"),
    (dict(vals=torch.zeros(8, 128)), ValueError, r"\(K, rows, 128\)"),
    (dict(vals=torch.zeros(2, 8, 128, dtype=torch.float64)), TypeError,
     "vals must be float32"),
    (dict(scales=torch.ones(2, dtype=torch.float16)), TypeError,
     "scales must be float32"),
    (dict(mask=torch.ones(3)), ValueError, "mask shape"),
    (dict(scales=torch.ones(1, 2)), ValueError, "scales shape"),
    (dict(vals=torch.zeros(0, 8, 128), scales=torch.ones(0),
          mask=torch.ones(0)), ValueError, "clients"),
    (dict(mask=torch.ones(2, device="meta")), ValueError, "is on meta"),
])
def test_codec_aggregate_checks_its_inputs(bad, err, match):
    args = dict(vals=torch.zeros(2, 8, 128), scales=torch.ones(2),
                mask=torch.ones(2))
    args.update(bad)
    with pytest.raises(err, match=match):
        codec.codec_aggregate(**args)


@pytest.mark.parametrize("k,rows,inactive", [(4, 8, False), (2, 64, False),
                                              (3, 8, True)])
def test_codec_aggregate_partial_matches_reference(k, rows, inactive):
    """K6 (one shard's masked sum) against the reference's plain version
    and its Pallas kernel in interpret mode; an all-inactive slab gives
    +0.0 everywhere."""
    rng = np.random.default_rng(k * 1000 + rows)
    vals = rng.standard_normal((k, rows, 128)).astype(np.float32)
    scales = rng.uniform(0.5, 2.0, (k,)).astype(np.float32)
    mask = (np.zeros(k, np.float32) if inactive
            else rng.integers(0, 2, (k,)).astype(np.float32))
    if not inactive:
        mask[0] = 1.0
    got = codec.codec_aggregate_partial(_t(vals), _t(scales), _t(mask))
    for want in (jref.codec_aggregate_partial_ref(jnp.asarray(vals),
                                                  jnp.asarray(scales),
                                                  jnp.asarray(mask)),
                 jcodec.codec_aggregate_partial(jnp.asarray(vals),
                                                jnp.asarray(scales),
                                                jnp.asarray(mask),
                                                interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=CODEC_TOL, atol=CODEC_TOL)
    if inactive:
        assert torch.equal(got, torch.zeros(rows, 128))
        assert not bool(torch.signbit(got).any())


@pytest.mark.parametrize("shards", [2, 5])
def test_codec_partials_over_shards_are_the_cohort_mean(shards):
    """The mesh's aggregate -- the sum of the shards' K6 partials over
    the sum of their mask counts -- against K5's plain version on the
    whole cohort (float association only: the sum is split across
    shards)."""
    rng = np.random.default_rng(shards)
    k = 10
    vals = _t(rng.standard_normal((k, 8, 128)).astype(np.float32))
    scales = _t(rng.uniform(0.5, 2.0, (k,)).astype(np.float32))
    mask = _t(np.array([1, 1, 0, 1, 1, 1, 0, 1, 1, 1], np.float32))
    kl = k // shards
    parts = [codec.codec_aggregate_partial(vals[i:i + kl], scales[i:i + kl],
                                           mask[i:i + kl])
             for i in range(0, k, kl)]
    cnt = sum(mask[i:i + kl].sum() for i in range(0, k, kl))
    got = sum(parts) / torch.clamp(cnt, min=1.0)
    want = ref.codec_aggregate_ref(vals, scales, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=CODEC_TOL,
                               atol=CODEC_TOL)
    # one shard holding the whole cohort is K5 before its division
    whole = codec.codec_aggregate_partial(vals, scales, mask)
    assert torch.equal(whole / mask.sum(), want)


@pytest.mark.parametrize("bad,err,match", [
    (dict(vals=torch.zeros(2, 8, 64)), ValueError, r"\(K, rows, 128\)"),
    (dict(vals=torch.zeros(2, 8, 128, dtype=torch.float64)), TypeError,
     "vals must be float32"),
    (dict(mask=torch.ones(3)), ValueError, "mask shape"),
    (dict(vals=torch.zeros(0, 8, 128), scales=torch.ones(0),
          mask=torch.ones(0)), ValueError, "clients"),
    (dict(scales=torch.ones(2, device="meta")), ValueError, "is on meta"),
])
def test_codec_aggregate_partial_checks_its_inputs(bad, err, match):
    args = dict(vals=torch.zeros(2, 8, 128), scales=torch.ones(2),
                mask=torch.ones(2))
    args.update(bad)
    with pytest.raises(err, match=match) as e:
        codec.codec_aggregate_partial(**args)
    assert str(e.value).startswith("codec_aggregate_partial: ")


def test_cpu_path_launches_no_kernel():
    """Launch counters move only where a kernel launches: never for CPU
    tensors, which take the plain versions."""
    build.reset_launch_counts()
    w = torch.ones(8, 128)
    ops.dane_update_flat_masked(w, w, w, w, 0.1, 0.0, torch.ones(1), 8)
    ops.dane_update_array(torch.ones(7), torch.ones(7), torch.ones(7),
                          torch.ones(7), 0.1, 0.0)
    codec.codec_aggregate(torch.ones(2, 8, 128), torch.ones(2),
                          torch.ones(2))
    codec.codec_aggregate_partial(torch.ones(2, 8, 128), torch.ones(2),
                                  torch.ones(2))
    assert set(build.launch_counts) >= {"codec_aggregate",
                                        "codec_aggregate_partial"}
    assert set(build.launch_counts.values()) == {0}


# -- K7's backward: the split walk of its dK/dV blocks ----------------------

def _bwd_walks(s, t, causal, period, own):
    """How often the backward's dK/dV blocks of ``own`` keys (64 in f32,
    128 in bf16: two warpgroups of 64) take each (row tile, key tile) pair
    under ``flash_attention.bwd_plan``: part ``p`` of key block ``kb``
    walks the tiles of ``[p * chunk, (p + 1) * chunk)`` whose rows see the
    block's first key, and each 64 keys of the block take a walked tile
    whose rows see their first key; ``vis`` marks the pairs that hold a
    visible (row, key)."""
    from repro_torch.kernels import flash_attention as fa
    tile = fa.BWD_TILE
    pos = np.arange(s) % period if period else np.arange(s)
    keys = np.arange(t)
    mask = (keys[None, :] <= pos[:, None]) if causal \
        else np.ones((s, t), bool)
    n_q, n_k = -(-s // tile), -(-t // tile)
    vis = np.zeros((n_q, n_k), bool)
    for i in range(n_q):
        for j in range(n_k):
            vis[i, j] = mask[i * tile:(i + 1) * tile,
                             j * tile:(j + 1) * tile].any()
    chunk, parts = fa.bwd_plan(s, period)
    walks = np.zeros((n_q, n_k), int)
    for kb in range(-(-t // own)):
        k0 = kb * own
        for p in range(parts):
            for qt in range(p * chunk, min((p + 1) * chunk, n_q)):
                rows = mask[qt * tile:(qt + 1) * tile]
                if not rows[:, k0].any():
                    continue
                for kt in range(k0 // tile, min((k0 + own) // tile, n_k)):
                    walks[qt, kt] += bool(rows[:, kt * tile].any())
    return vis, walks, parts


# the card tests' shapes, then chip_smoke's phase 3 shapes (h)-(l)
BWD_SHAPES = [
    (200, 200, True, 0), (4 * 200, 200, True, 200), (3 * 90, 60, True, 90),
    (100, 77, False, 0), (130, 130, True, 0), (1, 1, True, 0),
    (300, 300, True, 0), (260, 260, True, 0), (192, 192, False, 0),
    (100, 50, True, 0), (8 * 256, 256, True, 256), (300, 170, True, 0),
    (130, 300, False, 0), (4160, 4160, True, 0),
    (4096, 4096, True, 0), (64, 64, True, 0), (8 * 2048, 2048, True, 2048),
    (1000, 1000, True, 0)]


@pytest.mark.parametrize("s,t,causal,period", BWD_SHAPES)
@pytest.mark.parametrize("own", [64, 128])
def test_bwd_plan_walks_every_visible_tile_pair_once(s, t, causal, period,
                                                      own):
    """Across the parts of every dK/dV block, each (row tile, key tile)
    pair that holds a visible pair is walked exactly once, and no other."""
    vis, walks, parts = _bwd_walks(s, t, causal, period, own)
    assert np.array_equal(walks, vis.astype(int)), (s, t, period, parts)


def test_bwd_plan_splits_the_folds_and_long_walks():
    """One part a folded group (the yi-9b fold: 8 parts of 32 tiles, ~67 MB
    of f32 partials), one part up to 4,096 rows unfolded; the plan does not
    depend on BH."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.bwd_plan(8 * 2048, 2048) == (32, 8)
    assert fa.bwd_plan(4096, 0) == (64, 1)
    assert fa.bwd_plan(4160, 0) == (64, 2)
    assert fa.bwd_plan(64, 0) == (1, 1)
    assert fa.bwd_plan(3 * 90, 90) == (2, 3)
    s_pad = 16384
    assert fa.bwd_scratch_floats(4, 8 * 2048, 2048, 128, 2048) == \
        2 * 4 * s_pad + 2 * 8 * 4 * 2048 * 128
    assert 4 * 2 * 8 * 4 * 2048 * 128 == 67_108_864
    # no split: lse and D only, S padded to 128 rows
    assert fa.bwd_scratch_floats(3, 130, 77, 64) == 2 * 3 * 256


def test_library_digest_covers_included_headers(tmp_path, monkeypatch):
    """An edit to a header a source includes (directly or through another
    header) changes the library's path, so a stale build is not reused."""
    assert [p.name for p in build.sources("flash_attention_bwd")] == \
        ["flash_attention_bwd.cu", "hopper.cuh"]
    (tmp_path / "k.cu").write_text('#include <math.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setitem(build.EXTRA_FLAGS, "k", ())
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    before = build.library_path("k")
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert build.library_path("k") != before
