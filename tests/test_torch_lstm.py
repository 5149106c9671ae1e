"""The port's LSTM models (Sent140-like and Shakespeare-like) against the
JAX package's, on the CPU.

The reference's initial values (drawn from ``jax.random``) are carried
across with ``params_from_numpy``; the data comes from the generators,
whose arrays are bitwise equal in both packages.  Functions are held at
atol 1e-5; federated rounds at the repo's engine-parity bar
(tests/test_engine.py): identical selections, and params, loss history
and per-algorithm state within atol 1e-5 after 3 rounds.  Widths are cut
to hidden 16; vocabularies and sequence lengths are the published ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from torch.func import grad, vmap

from repro.configs.base import FederatedConfig as JConfig
from repro.core import FederatedTrainer as JTrainer
from repro.data import batching as jbatch
from repro.data import leaf_like as jleaf
from repro.kernels import flatpack as jflatpack
from repro.models import small as jsmall
from repro.models.param import init_params as j_init_params
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer
from repro_torch.core import pytree as pt
from repro_torch.core.client import make_batched_solver
from repro_torch.data import batching
from repro_torch.data.batching import stack_device_batches
from repro_torch.kernels import flatpack
from repro_torch.models import small
from repro_torch.models.param import params_from_numpy, params_to_numpy

ATOL = 1e-5
HIDDEN = 16

#: task -> (port specs/loss/logits/accuracy, reference's, label key,
#: Fig. 1's learning rate and local epochs, the devices' generator args)
TASKS = {
    "sent140": dict(
        specs=lambda m: m.sentlstm_specs(400, 25, HIDDEN),
        name="sentlstm", label="y", lr=0.1, epochs=1,
        generate=lambda g: g.generate_sent140_like(8, seed=0)),
    "shakespeare": dict(
        specs=lambda m: m.charlstm_specs(80, 8, HIDDEN),
        name="charlstm", label="labels", lr=0.3, epochs=1,
        # sizes 32..64 (not all at the cap), so that the batched engine
        # pads and masks
        generate=lambda g: g.generate_shakespeare_like(
            6, seed=0, mean_samples=48, stdev_samples=24, sample_cap=64)),
}
#: Fig. 1's mu per algorithm (benchmarks/fig1_convergence.py)
MUS = {"fedavg": 0.0, "fedprox": 1.0, "feddane": 0.001}


def _fn(module, task, what):
    return getattr(module, f"{TASKS[task]['name']}_{what}")


@pytest.fixture(scope="module", params=list(TASKS))
def task(request):
    """(task name, reference params as numpy, device arrays)."""
    name = request.param
    spec = TASKS[name]
    p0 = j_init_params(spec["specs"](jsmall), jax.random.PRNGKey(3))
    # the head's bias is zeros at init; give every leaf values to check
    p0 = jax.tree_util.tree_map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.PRNGKey(4),
                                               x.shape), p0)
    return name, jax.tree_util.tree_map(np.asarray, p0), \
        spec["generate"](jleaf)


def _batch(task_name, devices, k=0, n=10):
    label = TASKS[task_name]["label"]
    return {"tokens": devices[k]["tokens"][:n], label: devices[k][label][:n]}


def _close(got, want, atol=ATOL):
    g = pt.leaves(params_to_numpy(got))
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


def test_lstm_cell_and_run_match_reference():
    rng = np.random.default_rng(0)
    p = {"wx": rng.normal(size=(8, 4 * HIDDEN)).astype(np.float32) * 0.3,
         "wh": rng.normal(size=(HIDDEN, 4 * HIDDEN)).astype(np.float32)
         * 0.3,
         "b": rng.normal(size=4 * HIDDEN).astype(np.float32) * 0.1}
    h = rng.normal(size=(5, HIDDEN)).astype(np.float32)
    c = rng.normal(size=(5, HIDDEN)).astype(np.float32)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    tp = params_from_numpy(p, device="cpu")
    (th, tc), tout = small.lstm_cell(tp, (torch.from_numpy(h),
                                          torch.from_numpy(c)),
                                     torch.from_numpy(x))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    (jh, jc), jout = jsmall.lstm_cell(jp, (jnp.asarray(h), jnp.asarray(c)),
                                      jnp.asarray(x))
    for a, b in ((th, jh), (tc, jc), (tout, jout)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    xs = rng.normal(size=(5, 80, 8)).astype(np.float32)
    got = small.lstm_run(tp, torch.from_numpy(xs))
    want = jsmall.lstm_run(jp, jnp.asarray(xs))
    assert got.shape == (5, 80, HIDDEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_forget_gate_bias_and_gate_order():
    """Zero weights: gates = b.  Only the forget block's +1 enters c."""
    b = np.zeros(4 * HIDDEN, np.float32)
    b[2 * HIDDEN:3 * HIDDEN] = 0.5                       # g
    p = {"wx": torch.zeros(3, 4 * HIDDEN), "wh": torch.zeros(HIDDEN,
                                                            4 * HIDDEN),
         "b": torch.from_numpy(b)}
    c0 = torch.ones(1, HIDDEN)
    (_, c), _ = small.lstm_cell(p, (torch.zeros(1, HIDDEN), c0),
                                torch.zeros(1, 3))
    want = torch.sigmoid(torch.tensor(1.0)) + 0.5 * torch.tanh(
        torch.tensor(0.5))
    torch.testing.assert_close(c, torch.full((1, HIDDEN), float(want)))


def test_specs_match_reference(task):
    name, p0, _ = task
    tspecs = TASKS[name]["specs"](small)
    jspecs = TASKS[name]["specs"](jsmall)
    tl, jl = pt.leaves(tspecs), jax.tree_util.tree_leaves(
        jspecs, is_leaf=lambda s: hasattr(s, "init"))
    assert [(s.shape, s.axes, s.init) for s in tl] == \
        [(s.shape, s.axes, s.init) for s in jl]


def test_default_widths_are_the_papers():
    char = small.charlstm_specs(80)
    sent = small.sentlstm_specs(400)
    assert char["embed"].shape == (80, 8) and char["lstm2"]["wh"].shape == \
        (256, 1024)
    assert sent["embed"].shape == (400, 25) and sent["lstm1"]["wh"].shape \
        == (100, 400) and sent["head_w"].shape == (100, 2)
    from repro_torch.models.param import param_count
    assert param_count(char) == 817_872
    assert param_count(sent) == 60_602


def test_flat_pack_leaf_order_equals_reference(task):
    """The port's leaf order (sorted keys at every level) is the
    reference's, so the flat packs -- whose rows the codecs' draws index
    -- are bitwise equal."""
    _, p0, _ = task
    tp = params_from_numpy(p0, device="cpu")
    for a, b in zip(pt.leaves(tp), jax.tree_util.tree_leaves(p0)):
        np.testing.assert_array_equal(a.numpy(), b)
    tspec, jspec = flatpack.flat_spec(tp), jflatpack.flat_spec(p0)
    assert (tspec.shapes, tspec.sizes, tspec.offsets, tspec.rows) == \
        (jspec.shapes, jspec.sizes, jspec.offsets, jspec.rows)
    np.testing.assert_array_equal(
        flatpack.pack(tspec, tp).numpy(),
        np.asarray(jflatpack.pack(jspec, p0)))


@pytest.mark.parametrize("what", ["logits", "loss", "accuracy", "grad"])
def test_model_functions_match_reference(task, what):
    name, p0, devices = task
    batch = _batch(name, devices)
    tp = params_from_numpy(p0, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if what == "logits":
        got = _fn(small, name, "logits")(tp, tb["tokens"])
        want = _fn(jsmall, name, "logits")(jp, jb["tokens"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    elif what == "grad":
        _close(grad(_fn(small, name, "loss"))(tp, tb),
               jax.grad(_fn(jsmall, name, "loss"))(jp, jb))
    else:
        got = _fn(small, name, what)(tp, tb)
        want = _fn(jsmall, name, what)(jp, jb)
        assert got.ndim == 0
        np.testing.assert_allclose(float(got), float(want), atol=ATOL)


def test_vmapped_grad_takes_no_fallback(task):
    """``vmap(grad(loss))`` over K devices, as the batched engine runs it,
    with vmap's per-sample fallback switched off: every op (the
    embedding's scatter-add backward included) has a batching rule."""
    import torch._C._functorch as functorch
    name, p0, devices = task
    loss = _fn(small, name, "loss")
    tp = params_from_numpy(p0, device="cpu")
    stacked = pt.stack([{k: torch.from_numpy(v) for k, v in
                         _batch(name, devices, k).items()}
                        for k in range(3)])
    wk = pt.tmap(lambda x: x.expand((3,) + x.shape).contiguous(), tp)
    was = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    try:
        g = vmap(grad(loss))(wk, stacked)
    finally:
        functorch._set_vmap_fallback_enabled(was)
    for k in range(3):
        one = grad(loss)(tp, pt.index(stacked, k))
        for a, b in zip(pt.leaves(g), pt.leaves(one)):
            torch.testing.assert_close(a[k], b, atol=ATOL, rtol=0)


def test_token_batches_match_reference(task):
    """Integer token leaves pad, cycle, bucket and stack as in the
    reference."""
    _, _, devices = task
    tds = batching.FederatedData(devices, 10, device="cpu")
    jds = jbatch.FederatedData(devices, 10)
    sel = np.array([0, 3, 1, 3])
    tb, tv = stack_device_batches(tds, sel)
    jb, jv = jbatch.stack_device_batches(jds, sel)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for k in jb:
        assert tb[k].dtype == torch.int32
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


# -- federated rounds ---------------------------------------------------

def _record_samples(trainer):
    drawn, orig = [], trainer._sample

    def sample():
        s = orig()
        drawn.append(np.asarray(s).tolist())
        return s

    trainer._sample = sample
    return drawn


def _cfg_kw(task_name, algo, n):
    spec = TASKS[task_name]
    return dict(algorithm=algo, mu=MUS[algo], num_devices=n,
                devices_per_round=3, local_epochs=spec["epochs"],
                local_batch_size=10, learning_rate=spec["lr"], seed=7)


def _three_rounds(trainer, params):
    drawn = _record_samples(trainer)
    st, losses = trainer.init(params), []
    for _ in range(3):
        st = trainer.round(st)
        losses.append(trainer.global_loss(st.params))
    return st, drawn, losses


_REFERENCE = {}


def _reference(task, algo):
    name, p0, devices = task
    if (name, algo) not in _REFERENCE:
        jds = jbatch.FederatedData(devices, 10)
        tr = JTrainer(_fn(jsmall, name, "loss"), jds,
                      JConfig(engine="loop", round_driver="python",
                              **_cfg_kw(name, algo, len(devices))))
        _REFERENCE[name, algo] = _three_rounds(
            tr, jax.tree_util.tree_map(jnp.asarray, p0))
    return _REFERENCE[name, algo]


@pytest.mark.parametrize("engine", ["loop", "batched"])
@pytest.mark.parametrize("algo", list(MUS))
def test_rounds_match_reference(task, algo, engine):
    """3 rounds on the loop and batched engines against the reference's
    python driver: the same selections; params, loss history and state
    within atol 1e-5."""
    name, p0, devices = task
    want, j_drawn, j_losses = _reference(task, algo)
    tds = batching.FederatedData(devices, 10, device="cpu")
    tr = FederatedTrainer(_fn(small, name, "loss"), tds,
                          FederatedConfig(engine=engine,
                                          **_cfg_kw(name, algo,
                                                    len(devices))),
                          device="cpu")
    got, t_drawn, t_losses = _three_rounds(tr, params_from_numpy(
        p0, device="cpu"))
    assert t_drawn == j_drawn
    _close(got.params, want.params)
    np.testing.assert_allclose(t_losses, j_losses, atol=ATOL, rtol=0)
    assert (got.round, got.comm_rounds) == (want.round, want.comm_rounds)
    for field in ("g_prev", "controls", "c_server", "center", "opt_state"):
        assert (getattr(got, field) is None) == \
            (getattr(want, field) is None)


def test_flat_bitwise_equals_per_leaf(task):
    """Two epochs of the batched solver on a padded, masked selection:
    the flat and per_leaf modes agree bit for bit."""
    name, p0, devices = task
    tds = batching.FederatedData(devices, 10, device="cpu")
    batches, valid = stack_device_batches(tds, np.array([0, 3, 5]))
    valid[1, 0] = 0.0
    w0 = params_from_numpy(p0, device="cpu")
    rng = np.random.default_rng(1)
    corr = pt.tmap(lambda x: torch.from_numpy(
        (0.01 * rng.normal(size=(3,) + tuple(x.shape))).astype(np.float32)),
        w0)
    out = {}
    for mode in ("flat", "per_leaf"):
        solve = make_batched_solver(_fn(small, name, "loss"),
                                    learning_rate=TASKS[name]["lr"],
                                    num_epochs=2, solver=mode)
        out[mode] = solve(w0, corr, 0.001, batches, valid)
    for a, b in zip(pt.leaves(out["flat"].params),
                    pt.leaves(out["per_leaf"].params)):
        assert torch.equal(a, b)
    assert not torch.equal(pt.leaves(out["flat"].params)[0][0],
                           pt.leaves(w0)[0])
