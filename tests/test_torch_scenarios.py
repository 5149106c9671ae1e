"""The port's scenario layer against the JAX package's, on the CPU.

The python driver draws the scenario uniforms from the same numpy
stream as the reference, so the port must realize the reference's
environment exactly: the same ``active`` masks, the same ``work``
fractions (float32, bit for bit) and the same truncated step counts, on
both engines.  ``active`` and the step counts come from threshold tests
(``u < p``, ``lat <= deadline``, ``ceil(work * steps)``) that one ulp can
flip, which is why they are compared exactly.  Params are held to the
reference's engine-parity bar, atol 1e-5 after 3 rounds (float32 sums
run in another order in the two frameworks).

The structural checks port tests/test_scenarios.py: ideal is a no-op,
the all-active masked path equals ideal, partial work truncates, a
zero-active round is a no-op, and a scenario registered by the user runs
end to end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs.base import FederatedConfig as JConfig
from repro.core import FederatedTrainer as JTrainer
from repro.core import algorithms as j_algorithms
from repro.core import scenarios as jscn
from repro.data import make_synthetic as j_make_synthetic
from repro.models.param import init_params as j_init_params
from repro.models.small import logreg_loss as j_logreg_loss
from repro.models.small import logreg_specs as j_logreg_specs
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer
from repro_torch.core import algorithms as t_algorithms
from repro_torch.core import pytree as pt
from repro_torch.core import scenarios as tscn
from repro_torch.core.scenarios import f32math
from repro_torch.data import make_synthetic
from repro_torch.models.param import params_from_numpy, params_to_numpy
from repro_torch.models.small import logreg_loss

ATOL = 1e-5
N, K = 12, 4
SCENARIOS = ["ideal", "bernoulli", "diurnal", "stragglers",
             "stragglers_partial", "dropout", "partial_work", "hostile"]
#: Knobs that make every process bite at N=12, K=4: about 40% offline,
#: 30% dropout, a deadline a sigma=0.8 lognormal misses ~40% of the time.
KNOBS = dict(avail_prob=0.6, dropout_rate=0.3, straggler_deadline=1.2,
             straggler_sigma=0.8, partial_min_work=0.3, diurnal_period=3)
KW = dict(num_devices=N, devices_per_round=K, local_epochs=2,
          learning_rate=0.05, mu=0.01, seed=7, correction_decay=0.9,
          **KNOBS)


@pytest.fixture(scope="module")
def data():
    jds = j_make_synthetic(0.5, 0.5, num_devices=N, seed=2, batch_size=20)
    tds = make_synthetic(0.5, 0.5, num_devices=N, seed=2, batch_size=20,
                         device="cpu")
    p0 = j_init_params(j_logreg_specs(60, 10), jax.random.PRNGKey(0))
    return jds, tds, jax.tree_util.tree_map(np.asarray, p0)


def test_registry_lists_the_reference_builtins():
    assert tscn.available_scenarios() == jscn.available_scenarios() \
        == tuple(sorted(SCENARIOS))
    for name in SCENARIOS:
        j, t = jscn.scenario_spec(name), tscn.scenario_spec(name)
        assert tscn.env_channels(t) == jscn.env_channels(j)
        assert tscn.is_trivial(t) == jscn.is_trivial(j)
        assert (t.deadline_policy, t.dropout) == (j.deadline_policy,
                                                  j.dropout)


# -- the interpreter, bit for bit -------------------------------------------

@pytest.mark.parametrize("name", SCENARIOS)
def test_realize_env_matches_reference_bitwise(name):
    """``active``, ``work`` and the phase-A availability mask equal the
    reference's exactly over 40 seeds x 6 rounds of draws."""
    cfg = JConfig(num_devices=N, scenario=name, **KNOBS)
    jspec, tspec = jscn.scenario_spec(name), tscn.scenario_spec(name)
    late = 0
    for seed in range(40):
        rng = np.random.default_rng(seed)
        for t in range(6):
            sel = rng.choice(N, K, replace=False)
            uni = {c: rng.random(N) for c in jscn.env_channels(jspec)}
            j_uni = {c: jnp.asarray(v, jnp.float32) for c, v in uni.items()}
            t_uni = {c: torch.from_numpy(v).to(torch.float32)
                     for c, v in uni.items()}
            je = jscn.realize_env(jspec, cfg, N, jnp.asarray(sel), t, j_uni)
            te = tscn.realize_env(tspec, cfg, N, torch.from_numpy(sel), t,
                                  t_uni)
            np.testing.assert_array_equal(te.active.numpy(),
                                          np.asarray(je.active))
            np.testing.assert_array_equal(te.work.numpy(),
                                          np.asarray(je.work))
            np.testing.assert_array_equal(
                tscn.availability_mask(tspec, cfg, N, torch.from_numpy(sel),
                                       t, t_uni).numpy(),
                np.asarray(jscn.availability_mask(jspec, cfg, N,
                                                  jnp.asarray(sel), t,
                                                  j_uni)))
            late += int((te.work.numpy() < 1.0).sum())
    if name in ("stragglers_partial", "partial_work", "hostile"):
        assert late > 100          # the work fractions were exercised


def test_f32_exp_and_ndtri_match_reference_bitwise():
    """The latency chain exp(sigma * ndtri(u)) bit for bit, over 400k
    uniforms (torch.exp and torch.special.ndtri each differ by an ulp on
    about a tenth of them)."""
    rng = np.random.default_rng(0)
    u = np.clip(rng.random(400_000).astype(np.float32), 1e-6,
                1 - 1e-6).astype(np.float32)
    j_nd = jax.scipy.special.ndtri(jnp.asarray(u))
    t_nd = f32math.ndtri(torch.from_numpy(u))
    np.testing.assert_array_equal(t_nd.numpy(), np.asarray(j_nd))
    for sigma in (0.5, 0.8):
        np.testing.assert_array_equal(
            f32math.exp(sigma * t_nd).numpy(),
            np.asarray(jnp.exp(sigma * j_nd)))
    x = (rng.random(100_000) * 30 + 1e-4).astype(np.float32)
    np.testing.assert_array_equal(f32math.log(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.log(jnp.asarray(x))))


def test_fma_rounds_once():
    """f32math.fma against exact rational arithmetic, ties included."""
    from fractions import Fraction
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal(2000).astype(np.float32)
               for _ in range(3))
    # a*b = 1 + 2^-11 + 2^-24 lies halfway between two float32 values:
    # alone it rounds to even (down); 2^-80 above it, it must round up,
    # though float64 alone would round the sum back onto the tie
    a[:2] = b[:2] = np.float32(1.0 + 2.0 ** -12)
    c[0], c[1] = np.float32(0.0), np.float32(2.0 ** -80)
    got = f32math.fma(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda q: (abs(Fraction(float(q)) - exact),
                                         int(np.float32(q).view(np.int32))
                                         & 1))
        assert got[i] == best, (i, a[i], b[i], c[i])
    assert got[0] == np.float32(1.0 + 2.0 ** -11)
    assert got[1] == np.float32(1.0 + 2.0 ** -11 + 2.0 ** -23)


# -- whole rounds against the reference trainer -----------------------------

def _recorder(mod, monkeypatch):
    """Record every realized environment of trainers built from ``mod``
    (the reference's or the port's algorithms module)."""
    envs = []
    orig = mod.realize_env

    def realize(*args, **kw):
        env = orig(*args, **kw)
        envs.append((np.asarray(env.active).copy(),
                     np.asarray(env.work).copy()))
        return env

    monkeypatch.setattr(mod, "realize_env", realize)
    return envs


def _record_steps(trainer):
    """The step counts of the devices that solved, round after round in
    selection order, on either engine."""
    steps = []

    def wrap(fn, batched=False):
        def call(*args):
            res = fn(*args)
            n = np.asarray(res.num_steps).reshape(-1).astype(int)
            if batched and trainer.last_masks is not None:
                n = n[trainer.last_masks[1] > 0]     # the active devices
            steps.extend(n.tolist())
            return res
        return call

    if getattr(trainer, "engine", None) is not None:
        trainer.engine._solver = wrap(trainer.engine._solver, batched=True)
    else:
        trainer.solver = wrap(trainer.solver)
        trainer._solve_partial = wrap(trainer._solve_partial)
    return steps


def _record_samples(trainer):
    """Each round's device selections, as drawn."""
    drawn, orig = [], trainer._sample

    def sample():
        out = orig()
        drawn.append(np.asarray(out).tolist())
        return out

    trainer._sample = sample
    return drawn


_REF = {}


def _reference(data, monkeypatch, algo, scenario, **extra):
    key = (algo, scenario, tuple(sorted(extra.items())))
    if key not in _REF:
        jds, _, p0 = data
        envs = _recorder(j_algorithms, monkeypatch)
        tr = JTrainer(j_logreg_loss, jds,
                      JConfig(algorithm=algo, engine="loop",
                              scenario=scenario, **KW, **extra))
        steps = _record_steps(tr)
        drawn = _record_samples(tr)
        st = tr.init(jax.tree_util.tree_map(jnp.asarray, p0))
        effs = []
        for _ in range(3):
            st = tr.round(st)
            effs.append(tr.last_env)
        monkeypatch.undo()
        _REF[key] = (st, envs, steps, effs, drawn)
    return _REF[key]


def _port(data, monkeypatch, algo, scenario, engine, **extra):
    _, tds, p0 = data
    envs = _recorder(t_algorithms, monkeypatch)
    tr = FederatedTrainer(logreg_loss, tds,
                          FederatedConfig(algorithm=algo, engine=engine,
                                          scenario=scenario, **KW, **extra),
                          device="cpu")
    steps = _record_steps(tr)
    drawn = _record_samples(tr)
    st = tr.init(params_from_numpy(p0, device="cpu"))
    effs = []
    for _ in range(3):
        st = tr.round(st)
        effs.append(tr.last_env)
    monkeypatch.undo()
    return st, envs, steps, effs, drawn


def _close(got, want, atol=ATOL):
    g, w = pt.leaves(params_to_numpy(got)), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


@pytest.mark.parametrize("engine", ["loop", "batched"])
@pytest.mark.parametrize("algo", ["feddane", "fedavg", "scaffold"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_rounds_match_reference(data, monkeypatch, scenario, algo,
                                         engine):
    """3 rounds against the reference's looped path: the same
    selections, masks, work fractions and step counts exactly; params,
    controls and server state at atol 1e-5."""
    ref, r_envs, r_steps, r_effs, r_drawn = _reference(
        data, monkeypatch, algo, scenario)
    got, t_envs, t_steps, t_effs, t_drawn = _port(data, monkeypatch, algo,
                                                  scenario, engine)
    assert t_drawn == r_drawn
    assert len(t_envs) == len(r_envs) == (0 if scenario == "ideal" else 3)
    for (ta, tw), (ra, rw) in zip(t_envs, r_envs):
        np.testing.assert_array_equal(ta, ra)
        np.testing.assert_array_equal(tw, rw)
    assert t_steps == r_steps
    assert t_effs == r_effs
    _close(got.params, ref.params)
    if ref.controls is not None:
        _close(got.c_server, ref.c_server)
        for ck_t, ck_j in zip(got.controls, ref.controls):
            _close(ck_t, ck_j)


def test_scenario_draws_exercise_the_masks(data, monkeypatch):
    """The knobs above make hostile rounds drop and truncate devices (so
    the parity test compares non-trivial masks)."""
    _, envs, steps, effs, _ = _reference(data, monkeypatch, "feddane",
                                         "hostile")
    assert any(eff < K for _, eff in effs)
    assert min(steps) < 2 * 4          # E * nb with nb >= 4 here
    assert any((w < 1.0).any() for _, w in envs)


# -- structural checks (tests/test_scenarios.py) ----------------------------

def _run(data, algo, engine, num_rounds=3, sel=None, **over):
    _, tds, p0 = data
    kw = dict(KW, algorithm=algo, engine=engine)
    kw.update(over)
    tr = FederatedTrainer(logreg_loss, tds, FederatedConfig(**kw),
                          device="cpu")
    return tr.run(params_from_numpy(p0, device="cpu"), num_rounds,
                  selections=sel)


def _sel(rounds, seed=11):
    rng = np.random.default_rng(seed)
    return np.stack([np.stack([rng.choice(N, K, replace=False)
                               for _ in range(2)]) for _ in range(rounds)])


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_ideal_scenario_is_a_no_op(data, monkeypatch, engine):
    """Ideal realizes nothing: no draws from the sampling stream, no
    masks, the pre-scenario program (bitwise equal to a trainer whose
    scenario layer would raise if touched)."""
    def boom(*a, **k):
        raise AssertionError("ideal must not realize an environment")
    monkeypatch.setattr(t_algorithms, "realize_env", boom)
    _, tds, p0 = data
    tr = FederatedTrainer(logreg_loss, tds,
                          FederatedConfig(algorithm="feddane",
                                          engine=engine, **KW),
                          device="cpu")
    st = tr.init(params_from_numpy(p0, device="cpu"))
    st = tr.round(st)
    assert tr.last_masks is None and tr.last_env == (K, float(K))
    # only the two selections drew from the stream
    ref = np.random.default_rng(KW["seed"])
    for _ in range(2):
        ref.choice(N, K, replace=False, p=np.asarray(tds.weights))
    assert tr.rng.bit_generator.state == ref.bit_generator.state


@pytest.mark.parametrize("algo", ["fedavg", "feddane", "scaffold",
                                  "feddane_pipelined", "sdane"])
def test_all_active_masked_path_equals_ideal(data, algo):
    """bernoulli at avail_prob=1.0 runs the masked program with every
    device active at full work: it equals ideal on both engines."""
    sel = _sel(3)
    for engine in ("loop", "batched"):
        h_ideal, p_ideal = _run(data, algo, engine, sel=sel)
        h_full, p_full = _run(data, algo, engine, sel=sel,
                              scenario="bernoulli", avail_prob=1.0)
        np.testing.assert_allclose(h_ideal["loss"], h_full["loss"],
                                   atol=1e-6)
        for a, b in zip(pt.leaves(p_ideal), pt.leaves(p_full)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_partial_work_actually_truncates(data):
    sel = _sel(3, seed=7)
    for engine in ("loop", "batched"):
        h_ideal, _ = _run(data, "fedavg", engine, sel=sel)
        h_part, _ = _run(data, "fedavg", engine, sel=sel,
                         scenario="partial_work", partial_min_work=0.25)
        assert h_part["effective_k"] == [float(K)] * 3
        assert max(abs(a - b) for a, b in zip(h_ideal["loss"],
                                              h_part["loss"])) > 1e-7


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_zero_active_round_is_a_no_op(data, engine):
    _, _, p0 = data
    hist, p = _run(data, "fedavg", engine, num_rounds=2,
                   scenario="bernoulli", avail_prob=1e-9)
    assert hist["effective_k"] == [0.0, 0.0]
    assert hist["dropped"] == [float(K)] * 2
    for a, b in zip(pt.leaves(params_to_numpy(p)),
                    jax.tree_util.tree_leaves(p0)):
        np.testing.assert_array_equal(a, b)
    assert hist["loss"][0] == hist["loss"][1]


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_full_participation_spec_under_scenario(data, engine):
    """inexact_dane solves on every device: the environment covers N."""
    hist, _ = _run(data, "inexact_dane", engine, num_rounds=2,
                   scenario="bernoulli")
    assert hist["intended_k"] == [float(N)] * 2
    assert all(0.0 <= e <= N for e in hist["effective_k"])
    assert np.isfinite(hist["loss"]).all()


def test_register_your_own_scenario_end_to_end(data):
    """A deterministic availability process registered here runs on both
    engines with no core change; its effective K is predictable."""
    spec = tscn.ScenarioSpec(
        name="unit_even_only",
        summary="only even-indexed devices are ever reachable",
        availability=lambda cfg, n, t: (torch.arange(n) % 2 == 0).to(
            torch.float32))
    tscn.register_scenario(spec)
    try:
        sel = _sel(2, seed=3)
        for engine in ("loop", "batched"):
            hist, _ = _run(data, "fedavg", engine, num_rounds=2, sel=sel,
                           scenario="unit_even_only")
            assert hist["effective_k"] == [
                float((sel[t, 0] % 2 == 0).sum()) for t in range(2)]
    finally:
        tscn.unregister_scenario("unit_even_only")


def test_registry_mechanics():
    spec = tscn.ScenarioSpec(name="unit_env", summary="test-only")
    try:
        assert tscn.register_scenario(spec) is spec
        assert tscn.scenario_spec("unit_env") is spec
        assert "unit_env" in tscn.available_scenarios()
        with pytest.raises(ValueError, match="already registered"):
            tscn.register_scenario(spec)
        tscn.register_scenario(spec, override=True)
    finally:
        tscn.unregister_scenario("unit_env")
    with pytest.raises(ValueError, match="registered: bernoulli, "):
        tscn.scenario_spec("nope")
    with pytest.raises(ValueError, match="deadline_policy"):
        tscn.register_scenario(tscn.ScenarioSpec(
            name="bad", summary="", deadline_policy="partial"))
    with pytest.raises(ValueError, match="identifier"):
        tscn.register_scenario(tscn.ScenarioSpec(name="a b", summary=""))
    with pytest.raises(ValueError, match="unknown scenario"):
        FederatedConfig(scenario="nope")
