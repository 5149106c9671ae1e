"""The port's federated rounds against the JAX package's, on the CPU.

The same numpy-seeded data, zero-initialised logistic regression and
seed go through the reference ``FederatedTrainer(engine="loop")`` and the
port's trainer (device="cpu", so every kernel wrapper takes its plain
version).  The contract is the reference's own engine-parity bar
(tests/test_engine.py): identical device selections, and params plus
per-algorithm state within atol 1e-5 after 3 rounds -- float32 sums run
in another order in the two frameworks, so not bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs.base import FederatedConfig as JConfig
from repro.core import FederatedTrainer as JTrainer
from repro.core.client import _epoch_step_mask as j_epoch_step_mask
from repro.core.client import make_batched_grad_fn as j_batched_grad
from repro.data import make_synthetic as j_make_synthetic
from repro.models.param import init_params as j_init_params
from repro.models.small import logreg_loss as j_logreg_loss
from repro.models.small import logreg_specs as j_logreg_specs
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer
from repro_torch.core import pytree as pt
from repro_torch.core.client import (_epoch_step_mask, _resolve_solver_mode,
                                     make_batched_grad_fn,
                                     make_batched_solver)
from repro_torch.core.client_state import SparseClientState
from repro_torch.data import make_synthetic
from repro_torch.data.batching import stack_device_batches
from repro_torch.models.param import (init_params, params_from_numpy,
                                      params_to_numpy)
from repro_torch.models.small import logreg_loss, logreg_specs

ATOL = 1e-5
ALGOS = ["fedavg", "fedprox", "feddane", "inexact_dane",
         "feddane_pipelined", "feddane_decayed", "scaffold",
         "fedavgm", "sdane"]
KW = dict(num_devices=6, devices_per_round=3, local_epochs=2,
          learning_rate=0.05, mu=0.01, seed=7, correction_decay=0.9)


@pytest.fixture(scope="module")
def data():
    jds = j_make_synthetic(0.5, 0.5, num_devices=6, seed=2, batch_size=20)
    tds = make_synthetic(0.5, 0.5, num_devices=6, seed=2, batch_size=20,
                         device="cpu")
    p0 = j_init_params(j_logreg_specs(60, 10), jax.random.PRNGKey(0))
    return jds, tds, jax.tree_util.tree_map(np.asarray, p0)


def _record_samples(trainer):
    """Wrap the trainer's sampler so each round's draws are recorded."""
    drawn, orig = [], trainer._sample

    def sample():
        s = orig()
        drawn.append(np.asarray(s).tolist())
        return s

    trainer._sample = sample
    return drawn


def _close(got, want, atol=ATOL):
    g, w = pt.leaves(params_to_numpy(got)), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


_REFERENCE = {}


def _reference(data, algo, **extra):
    """The reference trainer's state after 3 rounds (cached per config)."""
    key = (algo, tuple(sorted(extra.items())))
    if key not in _REFERENCE:
        jds, _, p0 = data
        tr = JTrainer(j_logreg_loss, jds, JConfig(algorithm=algo, **KW,
                                                  **extra))
        drawn = _record_samples(tr)
        st = tr.init(jax.tree_util.tree_map(jnp.asarray, p0))
        for _ in range(3):
            st = tr.round(st)
        _REFERENCE[key] = (st, drawn)
    return _REFERENCE[key]


def _port(data, algo, **extra):
    _, tds, p0 = data
    tr = FederatedTrainer(logreg_loss, tds,
                          FederatedConfig(algorithm=algo, **KW, **extra),
                          device="cpu")
    drawn = _record_samples(tr)
    st = tr.init(params_from_numpy(p0, device="cpu"))
    for _ in range(3):
        st = tr.round(st)
    return st, drawn


def _assert_states_match(lo, ba):
    _close(ba.params, lo.params)
    assert lo.comm_rounds == ba.comm_rounds and lo.round == ba.round
    for field in ("g_prev", "c_server", "center", "opt_state"):
        want = getattr(lo, field)
        if want is None:
            assert getattr(ba, field) is None
        else:
            _close(getattr(ba, field), want)
    if lo.controls is not None:
        for ck_t, ck_j in zip(ba.controls, lo.controls):
            _close(ck_t, ck_j)


@pytest.mark.parametrize("engine", ["loop", "batched"])
@pytest.mark.parametrize("algo", ALGOS)
def test_trainer_matches_reference(data, algo, engine):
    """3 rounds, partial participation, heterogeneous device sizes (the
    batched stack pads and masks): same selections, same state."""
    lo, j_drawn = _reference(data, algo, engine="loop")
    ba, t_drawn = _port(data, algo, engine=engine)
    assert t_drawn == j_drawn
    _assert_states_match(lo, ba)


@pytest.mark.parametrize("mode", ["fused_epoch", "fused_step"])
def test_fused_modes_match_reference(data, mode):
    """feddane through the port's fused modes (plain K2/K3 on the CPU)
    against the reference's same modes (Pallas in interpret mode)."""
    lo, j_drawn = _reference(data, "feddane", engine="batched",
                             local_solver=mode)
    ba, t_drawn = _port(data, "feddane", engine="batched",
                        local_solver=mode)
    assert t_drawn == j_drawn
    _assert_states_match(lo, ba)


@pytest.fixture(scope="module")
def stacked(data):
    _, tds, p0 = data
    batches, valid = stack_device_batches(tds, np.array([0, 3, 5]))
    rng = np.random.default_rng(1)
    corr = {k: torch.from_numpy(
        (0.01 * rng.normal(size=(3,) + v.shape)).astype(np.float32))
        for k, v in p0.items()}
    return params_from_numpy(p0, device="cpu"), corr, batches, valid


def test_flat_bitwise_equals_per_leaf(stacked):
    w0, corr, batches, valid = stacked
    out = {}
    for mode in ("flat", "per_leaf"):
        solve = make_batched_solver(logreg_loss, learning_rate=0.05,
                                    num_epochs=2, solver=mode)
        out[mode] = solve(w0, corr, 0.1, batches, valid)
    for a, b in zip(pt.leaves(out["flat"].params),
                    pt.leaves(out["per_leaf"].params)):
        assert torch.equal(a, b)
    assert torch.equal(out["flat"].num_steps, out["per_leaf"].num_steps)


def test_resolve_solver_mode(stacked):
    w0, _, batches, _ = stacked
    with pytest.raises(ValueError, match="unknown solver mode"):
        _resolve_solver_mode("warp", logreg_loss, w0, batches, 2)
    # auto stays on the flat path for tensors on the CPU
    assert _resolve_solver_mode("auto", logreg_loss, w0, batches,
                                2) == "flat"
    assert _resolve_solver_mode("fused_epoch", logreg_loss, w0, batches,
                                2) == "fused_epoch"
    with pytest.raises(ValueError, match="no SolverSpec"):
        _resolve_solver_mode("fused_step", lambda w, b: 0.0, w0, batches,
                             2)
    bad = dict(batches, y=batches["y"].float())
    with pytest.raises(ValueError, match="rejects"):
        _resolve_solver_mode("fused_epoch", logreg_loss, w0, bad, 2)


def test_batched_grad_matches_reference(data, stacked):
    w0, _, batches, valid = stacked
    _, _, p0 = data
    want = j_batched_grad(j_logreg_loss)(
        jax.tree_util.tree_map(jnp.asarray, p0),
        {k: jnp.asarray(v.numpy()) for k, v in batches.items()},
        jnp.asarray(valid.numpy()))
    _close(make_batched_grad_fn(logreg_loss)(w0, batches, valid), want,
           atol=1e-6)


def test_epoch_step_mask_matches_reference():
    valid = np.array([[1.0, 0.0, 1.0], [1.0, 1.0, 1.0]], np.float32)
    limit = np.array([3.0, 2.0], np.float32)
    for lim in (None, limit):
        want = j_epoch_step_mask(jnp.asarray(valid), 3,
                                 None if lim is None else jnp.asarray(lim))
        got = _epoch_step_mask(torch.from_numpy(valid), 3,
                               None if lim is None
                               else torch.from_numpy(lim))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("algo", ["feddane", "feddane_pipelined", "fedavg",
                                  "scaffold"])
def test_run_history_matches_reference(data, algo):
    """``run()`` on the python driver: the same history keys and values,
    wire bytes exactly; injected selections drive both (the scanned
    driver's run is held in tests/test_torch_scan.py)."""
    jds, tds, p0 = data
    rng = np.random.default_rng(11)
    sel = np.stack([np.stack([rng.choice(6, 3, replace=False)
                              for _ in range(2)]) for _ in range(3)])
    jt = JTrainer(j_logreg_loss, jds, JConfig(algorithm=algo,
                                              engine="loop", **KW))
    jh, jp = jt.run(jax.tree_util.tree_map(jnp.asarray, p0), 3,
                    eval_every=2, selections=sel)
    tt = FederatedTrainer(logreg_loss, tds,
                          FederatedConfig(algorithm=algo, engine="batched",
                                          round_driver="python", **KW),
                          device="cpu")
    th, tp = tt.run(params_from_numpy(p0, device="cpu"), 3, eval_every=2,
                    selections=sel)
    assert th.keys() == jh.keys()
    for k in jh:
        if k == "loss":
            np.testing.assert_allclose(th[k], jh[k], atol=ATOL)
        else:
            assert th[k] == jh[k], k
    _close(tp, jp)


def test_global_loss_matches_reference(data):
    jds, tds, p0 = data
    rng = np.random.default_rng(3)
    p = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
         for k, v in p0.items()}
    jt = JTrainer(j_logreg_loss, jds, JConfig(engine="loop", **KW))
    tt = FederatedTrainer(logreg_loss, tds, FederatedConfig(**KW),
                          device="cpu")
    assert abs(tt.global_loss(params_from_numpy(p, device="cpu"))
               - jt.global_loss(jax.tree_util.tree_map(jnp.asarray, p))) \
        < ATOL


def test_init_params_zeros_for_logreg():
    p = init_params(logreg_specs(60, 10), torch.Generator().manual_seed(0),
                    device="cpu")
    assert p["w"].shape == (60, 10) and p["b"].shape == (10,)
    assert not any(bool(x.any()) for x in pt.leaves(p))


@pytest.mark.parametrize("kw", [
    dict(client_source="streaming", mesh_devices=2),
    dict(round_driver="buffered", mesh_devices=2),
    dict(round_driver="buffered", mesh_devices=4, edge_shards=2),
    dict(client_source="streaming", mesh_devices=4, edge_shards=2),
    dict(mesh_devices=2, round_driver="scan"),
    dict(client_source="streaming", round_driver="python",
         mesh_devices=2)])
def test_config_accepts_mesh_drivers(kw):
    """Every driver and streaming sources are ported on the client mesh
    (flat and tree); what stays refused is refused elsewhere: the loop
    engine on a mesh (``test_torch_sharding.py::
    test_config_rejects_bad_meshes``) and a K the ranks do not divide
    (at the trainer, ``::test_mesh_trainer_rejects``)."""
    cfg = FederatedConfig(**kw)
    assert cfg.mesh_devices == kw["mesh_devices"]
    with pytest.raises(ValueError, match="engine='loop'"):
        FederatedConfig(**dict(kw, engine="loop"))


@pytest.mark.parametrize("kw", [
    dict(round_driver="scan", client_source="streaming"),
    dict(round_driver="buffered", client_source="streaming"),
    dict(client_source="streaming"),
    dict(client_source="streaming", mesh_devices="auto")])
def test_config_accepts_streaming(kw):
    """Streaming sources are ported on every driver, in one process and
    on the client mesh."""
    assert FederatedConfig(**kw).client_source == "streaming"


@pytest.mark.parametrize("kw", [
    dict(scenario="bernoulli", round_driver="buffered"),
    dict(round_driver="buffered", codec="topk"),
    dict(round_driver="buffered"),
    dict(mesh_devices="auto", round_driver="buffered")])
def test_config_accepts_the_buffered_driver(kw):
    """The buffered driver is ported, on the client mesh too."""
    cfg = FederatedConfig(**kw)
    assert cfg.round_driver == "buffered"


@pytest.mark.parametrize("kw", [
    dict(round_driver="scan"), dict(codec="int8", round_driver="scan"),
    dict(mesh_devices="auto", round_driver="scan")])
def test_config_accepts_the_scan_driver(kw):
    """The scanned driver is ported, on the client mesh too."""
    cfg = FederatedConfig(**kw)
    assert cfg.round_driver == "scan"


@pytest.mark.parametrize("engine,driver,want", [
    ("batched", "auto", "scan"), ("loop", "auto", "python"),
    ("auto", "auto", "python"), ("loop", "scan", "scan"),
    ("batched", "python", "python")])
def test_auto_driver_resolves_as_the_reference(data, engine, driver, want):
    """``auto`` is ``scan`` wherever the engine resolved to ``batched``
    (on the CPU: ``engine="batched"``), as the reference resolves it."""
    _, tds, _ = data
    tr = FederatedTrainer(logreg_loss, tds,
                          FederatedConfig(engine=engine, round_driver=driver,
                                          **KW), device="cpu")
    assert tr._resolve_driver() == want


def test_scan_trainer_on_a_mesh_builds_and_auto_resolves_to_scan(
        monkeypatch, tmp_path):
    """On a 2-rank CPU mesh a scan trainer (and its scanned driver)
    builds, and ``auto`` resolves to the scanned driver on every rank, as
    the reference resolves it wherever the engine is batched."""
    import tempfile

    import _torch_mesh_child as child
    from repro_torch.core import sharding
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    res = sharding.run_on_mesh(child.driver_on_mesh, 2, device="cpu")
    assert res == [("scan", "scan")] * 2


def test_buffered_trainer_on_a_mesh_builds(monkeypatch, tmp_path):
    """On a 2-rank CPU mesh (``mesh_devices="auto"``) a buffered trainer
    builds on every rank and runs the buffered driver."""
    import tempfile

    import _torch_mesh_child as child
    from repro_torch.core import sharding
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    res = sharding.run_on_mesh(child.driver_on_mesh, 2, device="cpu",
                               args=("buffered",))
    assert res == [("buffered", "scan")] * 2


@pytest.mark.parametrize("kw", [
    dict(scenario="bernoulli", mesh_devices=2),
    dict(mesh_devices=2), dict(mesh_devices="auto"),
    dict(mesh_devices=4, edge_shards=2, codec="int8")])
def test_config_accepts_the_client_mesh(kw):
    """The config takes the client mesh (the ranks are checked against
    it when the trainer is built)."""
    cfg = FederatedConfig(**kw)
    assert cfg.mesh_devices == kw["mesh_devices"]


def test_config_accepts_every_registered_scenario_and_codec():
    """The python driver takes every registered scenario and codec, and
    the port registers the reference's."""
    from repro.core.codecs import available_codecs as j_codecs
    from repro.core.scenarios import available_scenarios as j_scenarios
    from repro_torch.core.codecs import available_codecs
    from repro_torch.core.scenarios import available_scenarios
    assert available_scenarios() == j_scenarios()
    assert available_codecs() == j_codecs()
    for scenario in available_scenarios():
        for codec in available_codecs():
            cfg = FederatedConfig(scenario=scenario, codec=codec,
                                  round_driver="python")
            assert (cfg.scenario, cfg.codec) == (scenario, codec)


@pytest.mark.parametrize("kw", [dict(algorithm="warp"),
                                dict(engine="warp"),
                                dict(local_solver="bogus"),
                                dict(server_opt="lion")])
def test_config_rejects_unknown_names(kw):
    with pytest.raises(ValueError):
        FederatedConfig(**kw)


# -- SparseClientState: exact equality, no subnormal flush --------------

def _tmpl():
    return {"a": torch.zeros(2), "b": torch.zeros(())}


def _fill(v):
    return pt.tmap(lambda x: torch.full_like(x, float(np.float32(v))),
                   _tmpl())


@pytest.mark.parametrize("vals", [
    [9.134416852807924e-40],          # subnormal: must not read as zero
    [0.0, -0.0, 1.5],
    [-2.0, 0.0, 1e-30, 0.0]])
def test_sparse_store_from_dense_roundtrip(vals):
    """from_dense(to_dense(.)) is the identity, and exactly the rows
    equal to the zero template (+0 or -0) stay unstored."""
    rows = [_fill(v) for v in vals]
    sp = SparseClientState.from_dense(rows)
    for a, b, v in zip(sp.to_dense(), rows, vals):
        for x, y in zip(pt.leaves(a), pt.leaves(b)):
            assert torch.equal(x, y)
            if np.float32(v) != 0.0:          # stored rows keep their bits
                assert torch.equal(x.view(torch.int32),
                                   y.view(torch.int32))
    assert len(sp) == sum(1 for v in vals if np.float32(v) != 0.0)


def test_sparse_store_gather_scatter_and_bounds():
    sp = SparseClientState(4, _tmpl())
    sp.scatter([2, 0, 2], pt.stack([_fill(1.0), _fill(2.0), _fill(3.0)]))
    got = sp.gather([0, 1, 2])
    assert got["a"][:, 0].tolist() == [2.0, 0.0, 3.0]
    assert len(sp) == 2
    with pytest.raises(IndexError):
        sp[4]
