"""The port's buffered driver against the JAX package's, on the CPU.

Mirrors tests/test_async_engine.py test for test, with its ``BASE_KW``
(synthetic(0.5,0.5), N=8, K=4, E=2, seed 7) and the reference's
zero-initialised weights carried across by ``params_from_numpy``.  On
top of that mirror:

- **against the reference's** ``BufferedDriver``: every algorithm in the
  degenerate configuration (``buffer_size == K``, ``ideal``, constant
  weights; injected selections), and feddane, scaffold and fedavg under
  ``hostile`` at N=8 and N=30 from the seed alone (both drivers draw
  selections and environments from numpy's ``default_rng(seed)``).
  Params and the loss at atol 1e-5, the reference's engine-parity bar
  (float32 sums run in another order in the two frameworks); every other
  history list exactly, since the event stream (selections, arrival
  times, commit order, staleness, bytes) comes from the host alone;
- ``realize_event_env`` bit for bit against the reference's eager call
  (the one its buffered driver makes), step caps included;
- lossy codecs with the reference's ``jax.random`` draws injected in
  place of ``codecs.round_draws`` (tests/test_torch_codecs.py), atol
  1e-4, the reference's cross-path bar for them; topk draws nothing and
  keeps 1e-5;
- checkpoints at the reference's commits and file names, in the bytes
  its store writes;
- ``server.staleness_weight`` and ``aggregate_buffered`` against the
  reference's functions and numpy.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.checkpoint import store as jstore
from repro.configs.base import FederatedConfig as JConfig
from repro.core import FederatedTrainer as JTrainer
from repro.core import codecs as jcodecs
from repro.core import scenarios as jscn
from repro.core import server as jserver
from repro.data import make_synthetic as j_make_synthetic
from repro.models.param import init_params as j_init_params
from repro.models.small import logreg_loss as j_logreg_loss
from repro.models.small import logreg_specs as j_logreg_specs
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import BufferedDriver, FederatedTrainer, server
from repro_torch.core import codecs as tcodecs
from repro_torch.core import pytree as pt
from repro_torch.core import scenarios as tscn
from repro_torch.data import make_synthetic
from repro_torch.kernels.flatpack import LANES
from repro_torch.models.param import params_from_numpy, params_to_numpy
from repro_torch.models.small import logreg_loss

ALGOS = ["fedavg", "fedprox", "feddane", "inexact_dane",
         "feddane_pipelined", "feddane_decayed", "scaffold",
         "fedavgm", "sdane"]
NUM_ROUNDS = 3
ATOL = 1e-5
LOSSY_ATOL = 1e-4
TELEMETRY_KEYS = ("staleness_mean", "staleness_max", "buffer_wait",
                  "anchor_age", "sim_time")

BASE_KW = dict(num_devices=8, devices_per_round=4, local_epochs=2,
               learning_rate=0.05, mu=0.01, seed=7, correction_decay=0.9)
#: The reference's seed-reproducibility configuration: every process of
#: ``hostile`` at its defaults, stragglers spread by sigma 0.8.
HOSTILE = dict(scenario="hostile", buffer_size=2, straggler_sigma=0.8)
#: Tests of the port's event loop alone (no reference run) solve on the
#: plain version of K2, the mode ``auto`` takes on the card: about 7x
#: faster on the CPU than ``auto``'s flat mode there.
FAST = dict(local_solver="fused_epoch")


def _data(n):
    return (j_make_synthetic(0.5, 0.5, num_devices=n, seed=2),
            make_synthetic(0.5, 0.5, num_devices=n, seed=2, device="cpu"))


@pytest.fixture(scope="module")
def setup():
    jds, tds = _data(8)
    p0 = j_init_params(j_logreg_specs(60, 10), jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    sel = np.stack([
        np.stack([rng.choice(8, 4, replace=False) for _ in range(2)])
        for _ in range(NUM_ROUNDS)])
    return jds, tds, jax.tree_util.tree_map(np.asarray, p0), sel


@pytest.fixture(scope="module")
def data30():
    return _data(30)


def _port(tds, p0, kw, rounds, **run_kw):
    tr = FederatedTrainer(logreg_loss, tds, FederatedConfig(**kw),
                          device="cpu")
    return tr.run(params_from_numpy(p0, device="cpu"), rounds, **run_kw)


def _reference(jds, p0, kw, rounds, **run_kw):
    tr = JTrainer(j_logreg_loss, jds, JConfig(**kw))
    return tr.run(jax.tree_util.tree_map(jnp.asarray, p0), rounds, **run_kw)


def _close(got, want, atol=ATOL, scaled=False):
    """Leafwise at ``atol``; ``scaled``: at ``atol`` times max(1, max
    |leaf|), float32's relative precision above 1."""
    g = pt.leaves(params_to_numpy(got))
    w = [np.asarray(b) for b in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        tol = atol * max(1.0, float(np.abs(b).max())) if scaled else atol
        np.testing.assert_allclose(a, b, atol=tol, rtol=0.0)


def _same(p1, p2):
    for a, b in zip(pt.leaves(p1), pt.leaves(p2)):
        assert torch.equal(a, b)


def _hist_match(got, want, atol=ATOL, scaled=False):
    """The loss at ``atol`` (``scaled``: times max(1, |loss|)), every
    other history list exactly."""
    assert list(got) == list(want)
    for k in want:
        if k == "loss":
            a, b = np.asarray(got[k]), np.asarray(want[k])
            tol = atol * np.maximum(1.0, np.abs(b)) if scaled else atol
            assert (np.abs(a - b) <= tol).all(), (a, b)
        else:
            assert list(got[k]) == list(want[k]), k


# -- 1. degenerate parity ---------------------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
def test_degenerate_parity(setup, algo):
    """buffer_size=K + zero latency + constant weights == the python
    driver, and == the reference's BufferedDriver on the same
    selections."""
    jds, tds, p0, sel = setup
    kw_s = dict(BASE_KW, algorithm=algo, round_driver="python",
                engine="loop")
    kw_b = dict(BASE_KW, algorithm=algo, round_driver="buffered",
                staleness_fn="constant")
    hist_s, p_s = _port(tds, p0, kw_s, NUM_ROUNDS, selections=sel)
    hist_b, p_b = _port(tds, p0, kw_b, NUM_ROUNDS, selections=sel)
    _close(p_b, params_to_numpy(p_s))
    np.testing.assert_allclose(hist_s["loss"], hist_b["loss"], atol=ATOL)
    # each commit was a full synchronous round with fresh anchors
    assert hist_b["staleness_max"] == [0.0] * NUM_ROUNDS
    assert hist_b["effective_k"] == hist_s["effective_k"]
    assert hist_b["sim_time"] == [float(t + 1) for t in range(NUM_ROUNDS)]
    hist_j, p_j = _reference(jds, p0, kw_b, NUM_ROUNDS, selections=sel)
    _close(p_b, p_j)
    _hist_match(hist_b, hist_j)


def test_polynomial_weighting_is_degenerate_at_zero_staleness(setup):
    """The default polynomial staleness_fn weighs fresh updates 1.0, so
    it too satisfies the degenerate contract."""
    _, tds, p0, sel = setup
    out = {}
    for fn in ("constant", "polynomial"):
        kw = dict(BASE_KW, algorithm="feddane", round_driver="buffered",
                  staleness_fn=fn)
        out[fn] = _port(tds, p0, kw, NUM_ROUNDS, selections=sel)
    _same(out["constant"][1], out["polynomial"][1])


def test_staleness_weight_families():
    """constant -> all ones; polynomial -> FedBuff (1+s)^{-1/2}; the
    reference's values; an unknown family raises."""
    s = np.array([0.0, 1.0, 2.0, 3.0, 8.0], np.float32)
    for name, want in (("constant", np.ones(5)),
                       ("polynomial", (1.0 + s) ** -0.5)):
        got = server.staleness_weight(name, torch.from_numpy(s))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jserver.staleness_weight(name, s)),
            rtol=1e-7, atol=0.0)
    with pytest.raises(ValueError, match="staleness_fn"):
        server.staleness_weight("linear", torch.from_numpy(s))
    assert server.STALENESS_FNS == jserver.STALENESS_FNS


def test_aggregate_buffered_weighted_mean():
    """aggregate_buffered == the numpy weighted mean and the reference's,
    per leaf."""
    rng = np.random.default_rng(0)
    buf = {"a": rng.normal(size=(3, 4)).astype(np.float32),
           "b": rng.normal(size=(3, 2, 2)).astype(np.float32)}
    w = np.array([1.0, 0.5, 0.25], np.float32)
    out = server.aggregate_buffered(
        {k: torch.from_numpy(v) for k, v in buf.items()},
        torch.from_numpy(w))
    ref = jserver.aggregate_buffered(
        {k: jnp.asarray(v) for k, v in buf.items()}, jnp.asarray(w))
    for key in buf:
        want = np.tensordot(w, buf[key], axes=(0, 0)) / w.sum()
        np.testing.assert_allclose(out[key].numpy(), want, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-6, atol=1e-7)
    # all weights zero: the 1e-12 floor keeps the mean finite (zero)
    zero = server.aggregate_buffered(
        {"a": torch.from_numpy(buf["a"])}, torch.zeros(3))
    assert torch.equal(zero["a"], torch.zeros(4))


def test_aggregate_weighted_matches_reference():
    rng = np.random.default_rng(1)
    ups = [{"w": rng.normal(size=(3, 2)).astype(np.float32)}
           for _ in range(3)]
    wts = [3.0, 1.0, 2.0]
    got = server.aggregate_weighted(
        [{"w": torch.from_numpy(u["w"])} for u in ups], wts)
    want = jserver.aggregate_weighted(
        [{"w": jnp.asarray(u["w"])} for u in ups], wts)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6, atol=1e-7)


# -- 2. event-queue edge cases ----------------------------------------------

def test_empty_buffer_at_horizon(setup):
    """An environment that never delivers an update ends at the event
    horizon with zero commits: empty history, params untouched."""
    _, tds, p0, _ = setup
    kw = dict(BASE_KW, **FAST, algorithm="fedavg", round_driver="buffered",
              scenario="bernoulli", avail_prob=1e-9, devices_per_round=2)
    hist, out = _port(tds, p0, kw, 1)
    assert hist["loss"] == [] and hist["sim_time"] == []
    _same(out, params_from_numpy(p0, device="cpu"))


@pytest.fixture
def bimodal():
    """half the fleet returns in 1 round, half in 3 -- registered in both
    packages."""
    for mod, name in ((jscn, "bimodal_latency_test"),
                      (tscn, "bimodal_latency_test")):
        mod.register_scenario(mod.ScenarioSpec(
            name=name, summary="half the fleet in 1 round, half in 3",
            latency_quantile=lambda cfg, u: 1.0 + 2.0 * (u > 0.5)))
    yield "bimodal_latency_test"
    jscn.unregister_scenario("bimodal_latency_test")
    tscn.unregister_scenario("bimodal_latency_test")


def test_all_updates_stale_beyond_max_staleness(setup, bimodal):
    """max_staleness=1 under a bimodal latency: every slow arrival is
    discarded and counted as dropped; the event stream is the
    reference's."""
    jds, tds, p0, _ = setup
    kw = dict(BASE_KW, algorithm="fedavg", round_driver="buffered",
              scenario=bimodal, buffer_size=1, max_staleness=1)
    hist, out = _port(tds, p0, kw, 10)
    assert len(hist["sim_time"]) == 10
    assert max(hist["staleness_max"]) <= 1.0
    assert sum(hist["dropped"]) > 0      # the slow half was discarded
    assert np.isfinite(hist["loss"]).all()
    hist_j, out_j = _reference(jds, p0, kw, 10)
    _hist_match(hist, hist_j)
    _close(out, out_j)


@pytest.fixture
def slowpoke():
    """deterministic spread: device latency 1 + u, in both packages."""
    for mod in (jscn, tscn):
        mod.register_scenario(mod.ScenarioSpec(
            name="slowpoke_test", summary="latency 1 + u",
            latency_quantile=lambda cfg, u: 1.0 + u))
    yield "slowpoke_test"
    jscn.unregister_scenario("slowpoke_test")
    tscn.unregister_scenario("slowpoke_test")


@pytest.mark.parametrize("algo", ["fedavg", "scaffold"])
def test_duplicate_client_completions(setup, slowpoke, algo):
    """A client relaunched while its earlier update still travels has two
    solves in flight; both are delivered and committed, controls resolve
    by arrival order -- as in the reference."""
    jds, tds, p0, _ = setup
    sel = np.tile(np.array([[0, 1, 2, 3]]), (40, 1))
    kw = dict(BASE_KW, algorithm=algo, round_driver="buffered",
              scenario=slowpoke, buffer_size=1)
    hist, out = _port(tds, p0, kw, 8, selections=sel)
    assert len(hist["sim_time"]) == 8
    assert np.isfinite(hist["loss"]).all()
    assert all(np.isfinite(hist[k]).all() for k in TELEMETRY_KEYS)
    hist_j, out_j = _reference(jds, p0, kw, 8, selections=sel)
    _hist_match(hist, hist_j)
    _close(out, out_j)


def test_validation():
    """Knob validation at config construction, and the compositions the
    port takes or refuses."""
    with pytest.raises(ValueError, match="staleness_fn"):
        FederatedConfig(staleness_fn="nope")
    with pytest.raises(ValueError, match="buffer_size"):
        FederatedConfig(buffer_size=-1)
    with pytest.raises(ValueError, match="max_staleness"):
        FederatedConfig(max_staleness=-2)
    with pytest.raises(ValueError, match="round_driver"):
        FederatedConfig(round_driver="threads")
    with pytest.raises(ValueError, match="engine"):
        FederatedConfig(engine="vmap")
    with pytest.raises(ValueError, match="mesh_devices"):
        FederatedConfig(engine="loop", mesh_devices=2)
    # scaffold + replacement builds: sequential duplicate solves
    ds = make_synthetic(0.5, 0.5, num_devices=4, seed=0, device="cpu")
    cfg = FederatedConfig(algorithm="scaffold", round_driver="buffered",
                          sample_with_replacement=True, num_devices=4,
                          devices_per_round=2)
    tr = FederatedTrainer(logreg_loss, ds, cfg, device="cpu")
    assert isinstance(tr._buffered, BufferedDriver)
    assert tr._resolve_driver() == "buffered"


def test_degenerate_parity_with_replacement(setup):
    """scaffold + sample_with_replacement: duplicates within one cohort
    are solved in sequential occurrence layers, matching the python
    driver's per-duplicate control updates and the reference's buffered
    driver at atol 1e-5."""
    jds, tds, p0, _ = setup
    rng = np.random.default_rng(3)
    sel = np.stack([rng.choice(8, 4, replace=True)
                    for _ in range(NUM_ROUNDS)])
    sel[:, 1] = sel[:, 0]           # duplicates every window
    kw = dict(BASE_KW, sample_with_replacement=True)
    for algo in ("scaffold", "fedavg"):
        kw_s = dict(kw, algorithm=algo, round_driver="python",
                    engine="loop")
        kw_b = dict(kw, algorithm=algo, round_driver="buffered",
                    staleness_fn="constant")
        hist_s, p_s = _port(tds, p0, kw_s, NUM_ROUNDS, selections=sel)
        hist_b, p_b = _port(tds, p0, kw_b, NUM_ROUNDS, selections=sel)
        _close(p_b, params_to_numpy(p_s))
        np.testing.assert_allclose(hist_s["loss"], hist_b["loss"],
                                   atol=ATOL)
        hist_j, p_j = _reference(jds, p0, kw_b, NUM_ROUNDS, selections=sel)
        _close(p_b, p_j)
        _hist_match(hist_b, hist_j)


def test_duplicate_with_topk_error_feedback(setup):
    """A client twice in one commit window under top-k: both occurrences
    read the same pre-launch error feedback, the writeback resolves in
    cohort order -- the python driver's semantics, degenerate parity
    included the error feedback's effect on later rounds."""
    _, tds, p0, _ = setup
    sel = np.tile(np.array([[0, 0, 2, 3]]), (NUM_ROUNDS + 2, 1))
    kw = dict(BASE_KW, algorithm="scaffold", sample_with_replacement=True,
              codec="topk", topk_frac=0.2)
    hist_s, p_s = _port(tds, p0, dict(kw, round_driver="python",
                                      engine="loop"),
                        NUM_ROUNDS + 2, selections=sel)
    hist_b, p_b = _port(tds, p0, dict(kw, round_driver="buffered",
                                      staleness_fn="constant"),
                        NUM_ROUNDS + 2, selections=sel)
    _close(p_b, params_to_numpy(p_s))
    np.testing.assert_allclose(hist_s["loss"], hist_b["loss"], atol=ATOL)


# -- 3. determinism + telemetry ---------------------------------------------

def test_event_stream_seed_reproducible(setup):
    """A fixed seed gives the same event stream and params, bit for bit,
    across run() calls and fresh driver instances."""
    _, tds, p0, _ = setup
    cfg = FederatedConfig(algorithm="feddane", round_driver="buffered",
                          **HOSTILE, **FAST, **BASE_KW)
    tr = FederatedTrainer(logreg_loss, tds, cfg, device="cpu")
    h1, p1 = tr.run(params_from_numpy(p0, device="cpu"), 5)
    h2, p2 = tr.run(params_from_numpy(p0, device="cpu"), 5)
    drv = BufferedDriver(logreg_loss, tds, cfg, device="cpu")
    h3, p3 = drv.run(params_from_numpy(p0, device="cpu"), 5)
    assert h1 == h2 == h3
    _same(p1, p2)
    _same(p1, p3)


def test_staleness_telemetry_recorded(setup):
    """Every commit records the async telemetry, finite, one entry per
    commit, beside the synchronous effective-K fields."""
    _, tds, p0, _ = setup
    kw = dict(BASE_KW, **FAST, algorithm="scaffold",
              round_driver="buffered", scenario="stragglers", buffer_size=2,
              straggler_sigma=0.6)
    hist, _ = _port(tds, p0, kw, 5)
    for key in TELEMETRY_KEYS + ("intended_k", "effective_k", "dropped"):
        assert len(hist[key]) == 5, key
        assert np.isfinite(hist[key]).all(), key
    assert hist["effective_k"] == [2.0] * 5       # M commits exactly
    assert all(a >= b for a, b in zip(hist["intended_k"],
                                      hist["effective_k"]))
    assert hist["sim_time"] == sorted(hist["sim_time"])


def test_more_commits_per_simtime_than_sync_drop(setup):
    """Under ``stragglers`` the buffered driver commits more server steps
    per unit of simulated time than the synchronous drop-path barrier,
    by the reference's wallclock model of that barrier."""
    _, tds, p0, _ = setup
    kw = dict(BASE_KW, scenario="stragglers", straggler_sigma=0.6)
    rounds = 8
    cfg = FederatedConfig(algorithm="fedavg", round_driver="buffered",
                          buffer_size=2, **FAST, **kw)
    hist, _ = FederatedTrainer(logreg_loss, tds, cfg, device="cpu").run(
        params_from_numpy(p0, device="cpu"), rounds)
    buffered_rate = rounds / hist["sim_time"][-1]
    rng = np.random.default_rng(kw["seed"])
    t_sync = 0.0
    for _ in range(rounds):
        lat = np.exp(kw["straggler_sigma"]
                     * rng.standard_normal(kw["devices_per_round"]))
        t_sync += min(float(lat.max()), cfg.straggler_deadline)
    assert buffered_rate > rounds / t_sync


def test_buffer_size_zero_defaults_to_cohort(setup):
    """buffer_size=0 means M=K: the commit cadence is the round's."""
    _, tds, p0, sel = setup
    kw = dict(BASE_KW, algorithm="fedavg", round_driver="buffered",
              buffer_size=0)
    hist, _ = _port(tds, p0, kw, 2, selections=sel)
    assert hist["effective_k"] == [4.0, 4.0]


def test_run_contract_matches_trainer(setup):
    """eval_every and the spec's communication cost per commit, as on the
    synchronous drivers."""
    _, tds, p0, sel = setup
    kw = dict(BASE_KW, algorithm="fedavg", round_driver="buffered")
    hist, _ = _port(tds, p0, kw, NUM_ROUNDS, eval_every=2, selections=sel)
    assert hist["round"] == [1.0, 3.0]
    assert len(hist["sim_time"]) == NUM_ROUNDS
    hist2, _ = _port(tds, p0, dict(kw, algorithm="feddane"), 2,
                     selections=sel)
    assert hist2["comm_rounds"] == [2.0, 4.0]     # two-phase cost


# -- 4. the reference's BufferedDriver, asynchronous ------------------------

@pytest.mark.parametrize("n", [8, 30])
@pytest.mark.parametrize("algo", ["feddane", "scaffold", "fedavg"])
def test_hostile_matches_reference(setup, data30, n, algo):
    """Under ``hostile`` with stale updates, polynomial weights and no
    injected selections, the port's event stream IS the reference's:
    every telemetry list equal; params and loss at 1e-5 times max(1,
    |value|) (the leaf's max for params).  The scale is for feddane at
    N=30, which diverges here (loss 8.5 -> 35, max |w| 6.2, where a
    float32 ulp is 4.8e-7): a 1e-7 nudge of w0 moves the reference's
    own params by 6.1e-6 there and its loss by 2.4e-5."""
    jds, tds = setup[:2] if n == 8 else data30
    p0 = setup[2]
    kw = dict(BASE_KW, **HOSTILE, algorithm=algo, round_driver="buffered",
              num_devices=n)
    hist, p = _port(tds, p0, kw, 5)
    hist_j, p_j = _reference(jds, p0, kw, 5)
    _hist_match(hist, hist_j, scaled=True)
    _close(p, p_j, scaled=True)
    assert max(hist["staleness_max"]) > 0        # really asynchronous
    assert hist["sim_time"] != [1.0, 2.0, 3.0, 4.0, 5.0]   # stragglers


@pytest.mark.parametrize("min_work", [0.3, 0.5])
@pytest.mark.parametrize("n", [8, 12, 30, 200])
def test_realize_event_env_matches_reference_bitwise(n, min_work):
    """delivered, work and latency of every client equal the reference's
    eager ``realize_event_env`` bit for bit, and so do the step caps
    ``min(total, ceil(work * total))`` for every total up to 4,096 (at
    N=8 / min work 0.3 the eager linspace gives client 1 0.4, where the
    compiled one gives 0.40000004: the port takes the eager form here)."""
    kw = dict(num_devices=n, scenario="hostile", avail_prob=0.6,
              dropout_rate=0.3, straggler_sigma=0.8,
              partial_min_work=min_work)
    rng = np.random.default_rng(n)
    u = {c: rng.random(n).astype(np.float32)
         for c in jscn.env_channels(jscn.scenario_spec("hostile"))}
    sel = rng.choice(n, min(n, 10), replace=False)
    want = jscn.realize_event_env(
        jscn.scenario_spec("hostile"), JConfig(**kw), n, jnp.asarray(sel),
        3, {c: jnp.asarray(v) for c, v in u.items()})
    got = tscn.realize_event_env(
        tscn.scenario_spec("hostile"), FederatedConfig(**kw), n,
        torch.from_numpy(sel), 3, {c: torch.from_numpy(v)
                                   for c, v in u.items()})
    assert isinstance(got, tscn.EventEnv)
    for f in ("delivered", "work", "latency"):
        assert np.array_equal(np.asarray(getattr(want, f)).view(np.int32),
                              getattr(got, f).numpy().view(np.int32)), f
    # the step caps, in the buffered driver's numpy dtypes
    total = np.arange(1, 4097, dtype=np.float32)
    cap_j = np.minimum(total, np.ceil(np.asarray(want.work)[:, None]
                                      * total))
    cap_t = np.minimum(total, np.ceil(got.work.numpy()[:, None] * total))
    assert np.array_equal(cap_j, cap_t)


def reference_draws(spec, cfg, t, k, rows, device="cpu", idx0=0):
    """The reference's codec draws of commit ``t`` (its ``round_key`` and
    ``fold_in`` constants) for cohort slots ``idx0 .. idx0+k-1``, in the
    port's ``CodecDraws`` form; ``k`` may be 0 (the commit's noise)."""
    if not spec.uses_rng:
        return None
    key = jcodecs.round_key(cfg, t)
    signs = jax.random.rademacher(jax.random.fold_in(key, 0x5167), (LANES,),
                                  dtype=jnp.float32)
    u = (jnp.stack([jax.random.uniform(jax.random.fold_in(key, idx0 + i),
                                       (rows, LANES)) for i in range(k)])
         if k else jnp.zeros((0, rows, LANES), jnp.float32))
    noise = jax.random.normal(jax.random.fold_in(key, 0x0D99),
                              (rows, LANES))
    return tcodecs.CodecDraws(*(torch.from_numpy(np.array(a)).to(device)
                                for a in (signs, u, noise)))


@pytest.mark.parametrize("codec,algo,atol", [
    ("int8", "feddane", LOSSY_ATOL), ("dp_gauss", "feddane", LOSSY_ATOL),
    ("topk", "fedavg", ATOL)])
def test_lossy_codecs_match_reference(setup, monkeypatch, codec, algo,
                                      atol):
    """Codecs on the buffered driver, under ``hostile`` with stale
    updates: encode at launch (error feedback refreshed only for
    deliveries), the decoded deltas committed, dp_gauss's noise at
    commit.  With the reference's draws the port matches it: the event
    stream exactly, params and loss at the lossy bar; topk draws nothing
    and is held to 1e-5.  topk's threshold is a discontinuity that
    feddane's correction amplifies: there a 1e-7 nudge of w0 moves the
    reference's own run by up to 0.5 in 5 commits, so topk runs fedavg,
    with half the coordinates kept, where the kept set stays the
    reference's."""
    jds, tds, p0, _ = setup
    monkeypatch.setattr(tcodecs, "round_draws", reference_draws)
    kw = dict(BASE_KW, **HOSTILE, algorithm=algo, round_driver="buffered",
              codec=codec, topk_frac=0.5)
    hist, p = _port(tds, p0, kw, 5)
    hist_j, p_j = _reference(jds, p0, kw, 5)
    _hist_match(hist, hist_j, atol=atol)
    _close(p, p_j, atol=atol)


def test_checkpoints_match_reference(setup, tmp_path):
    """Saves at the reference's commits (every ``chunk_rounds``-th and
    the last) under its file names; each holds the reference's params
    (atol 1e-5) and commit count, in exactly the bytes the reference's
    store writes for the port's tree; the last is the returned params."""
    jds, tds, p0, _ = setup
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = dict(BASE_KW, **HOSTILE, algorithm="scaffold",
              round_driver="buffered", chunk_rounds=2)
    _reference(jds, p0, kw, 5, checkpoint_dir=jdir)
    _, p = _port(tds, p0, kw, 5, checkpoint_dir=tdir)
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) == [
        "ckpt_00000002.msgpack", "ckpt_00000004.msgpack",
        "ckpt_00000005.msgpack"]
    for n in names:
        got = load_checkpoint(os.path.join(tdir, n), device="cpu")
        want = jstore.load_checkpoint(os.path.join(jdir, n))
        assert got["round"] == want["round"] == int(n[5:13])
        _close(got["params"], want["params"])
        again = str(tmp_path / f"again_{n}")
        jstore.save_checkpoint(again, {
            "params": params_to_numpy(got["params"]),
            "round": got["round"]})
        with open(again, "rb") as a, \
                open(os.path.join(tdir, n), "rb") as b:
            assert a.read() == b.read()
    last = load_checkpoint(os.path.join(tdir, names[-1]), device="cpu")
    _same(last["params"], p)

