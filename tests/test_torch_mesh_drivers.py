"""The port's scanned and buffered drivers, and streaming sources, on the
client mesh, against the reference's unsharded drivers.

The port's mesh is D processes (``core/sharding.py``): here 4 gloo ranks
on the CPU, once per mesh shape -- a flat 4-rank mesh and a ``(2, 2)``
tree of two edges of two leaves -- each running every case of
``tests/_torch_mesh_drivers_child.py``.  The inputs are
tests/test_torch_sharding.py's: synthetic(1,1), N=16, K=8, E=2,
lr=0.01, mu=0.001, seed 3, injected selections, 3 rounds.

The reference's own scanned and buffered drivers fail on any mesh under
this JAX (``ShardingTypeError`` in the scan's all-client gather,
``engine.py:749-750``, and in the buffered driver's per-flight slicing,
``async_engine.py:570``; ROADMAP Queue 3 R4), so the port's mesh is held
to the reference's UNSHARDED drivers, as its python-driver mesh is held
to the reference's plain program.  The ranks solve on ``fused_epoch``
(the mode ``auto`` takes on the card; its plain version here), the
reference on its CPU ``auto`` (flat): the port's parity bar between them
is 1e-5.  Bars, after the reference's checks (tests/_sharded_child.py):

- scanned driver, every algorithm of tests/test_scan_driver.py: params
  and loss history at 1e-5, the other history keys exactly, ``sharded``
  1.0 every round; N=18 (not divisible by 4): scaffold replicated,
  within 1e-5, ``sharded`` 0.0;
- ``bernoulli`` and ``hostile`` on the reference's uniforms: every
  round's solve and phase-A masks bitwise the reference interpreter's;
- int8 and topk fed the reference's draws: 1e-4, ``bytes_up`` exactly;
- sampled selections: bitwise the port's single-process scanned driver
  on the same CPU generator;
- buffered driver: fedavg, feddane and scaffold degenerate at 1e-5;
  ``hostile`` with M=5, every history list but the loss exactly;
  ``buffer_size=6`` (the buffer padded to 8) with int8 at 1e-4;
  scaffold's duplicate arrivals in occurrence layers at 1e-5;
- streaming (python, scan, buffered) against the port's single-process
  streaming run: the samplers' draws bitwise, params within 1e-5, and
  each rank generating only its rows (the python and scanned drivers:
  the eval sample plus K/D clients a phase and round);
- ``auto`` runs the scanned driver on a mesh;
- across ranks: every result bitwise equal.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_mesh_drivers_child as child
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_scan import reference_env_uniforms
from test_torch_sharding import _draws_table

from repro.configs.base import FederatedConfig as JConfig
from repro.core import FederatedTrainer as JTrainer
from repro.core import scenarios as jscn
from repro.data import make_synthetic as j_make_synthetic
from repro.models.param import init_params as j_init_params
from repro.models.small import logreg_loss as j_logreg_loss
from repro.models.small import logreg_specs as j_logreg_specs
from repro_torch.core import sharding

N, K, ROUNDS = 16, 8, 3
KW = dict(num_devices=N, devices_per_round=K, local_epochs=2,
          learning_rate=0.01, mu=0.001, seed=3)
PORT = dict(engine="batched", local_solver="fused_epoch")
ATOL = 1e-5
CODEC_ATOL = 1e-4
ALGOS = ["fedavg", "fedprox", "feddane", "inexact_dane",
         "feddane_pipelined", "feddane_decayed", "scaffold",
         "fedavgm", "sdane"]
SCENARIOS = {"bernoulli": dict(scenario="bernoulli", avail_prob=0.5),
             "hostile": dict(scenario="hostile", avail_prob=0.6,
                             dropout_rate=0.3, straggler_deadline=1.2,
                             straggler_sigma=0.8, partial_min_work=0.3)}
CODECS = ("int8", "topk")
BUFFERED = ("fedavg", "feddane", "scaffold")
STREAM_N = 1000
STREAM_ROUNDS = 2
MESHES = {"flat": (4, 1), "tree": (4, 2)}
TELEMETRY = ("round", "comm_rounds", "intended_k", "effective_k",
             "dropped", "staleness_mean", "staleness_max", "buffer_wait",
             "anchor_age", "sim_time", "bytes_up", "bytes_down")


def _sel(n):
    return np.stack([np.stack([(np.arange(K) + t) % n,
                               (np.arange(K) + t + 4) % n])
                     for t in range(ROUNDS)])


SEL, SEL18 = _sel(N), _sel(18)
SEL_DUP = SEL[:, 0, :].copy()
SEL_DUP[:, 1] = SEL_DUP[:, 0]          # client t+0 twice in every cohort


def _case(kw, data=("dense", N), rounds=ROUNDS, sel=None, **extra):
    return dict(kw=dict(KW, **PORT, **kw), data=data, rounds=rounds,
                sel=sel, **extra)


def _scan_env(case):
    return reference_env_uniforms(JConfig(**dict(KW, **SCENARIOS[case])),
                                  ROUNDS, N)


#: name -> (port case, reference config kwargs or None, what it checks)
CASES = {}
for _a in ALGOS:
    CASES[f"scan/{_a}"] = (_case(dict(algorithm=_a, round_driver="scan"),
                                 sel=SEL),
                           dict(algorithm=_a, round_driver="scan"))
CASES["scan/scaffold_n18"] = (
    _case(dict(algorithm="scaffold", round_driver="scan", num_devices=18),
          data=("dense", 18), sel=SEL18),
    dict(algorithm="scaffold", round_driver="scan", num_devices=18))
for _s, _kw in SCENARIOS.items():
    CASES[f"scan/{_s}"] = (
        _case(dict(algorithm="feddane", round_driver="scan", **_kw),
              sel=SEL, env=_scan_env(_s)),
        dict(algorithm="feddane", round_driver="scan", **_kw))
for _c in CODECS:
    CASES[f"scan/{_c}"] = (
        _case(dict(algorithm="feddane", round_driver="scan", codec=_c),
              sel=SEL, draws=_draws_table(_c)),
        dict(algorithm="feddane", round_driver="scan", codec=_c))
CASES["scan/sampled"] = (
    _case(dict(algorithm="feddane", round_driver="scan")), None)
CASES["scan/auto"] = (_case(dict(algorithm="feddane")), None)
for _a in BUFFERED:
    CASES[f"buffered/{_a}"] = (
        _case(dict(algorithm=_a, round_driver="buffered"), sel=SEL),
        dict(algorithm=_a, round_driver="buffered"))
CASES["buffered/hostile"] = (
    _case(dict(algorithm="feddane", round_driver="buffered", buffer_size=5,
               **SCENARIOS["hostile"]), rounds=4),
    dict(algorithm="feddane", round_driver="buffered", buffer_size=5,
         **SCENARIOS["hostile"]))
CASES["buffered/int8_m6"] = (
    _case(dict(algorithm="feddane", round_driver="buffered", buffer_size=6,
               codec="int8"), draws=_draws_table("int8")),
    dict(algorithm="feddane", round_driver="buffered", buffer_size=6,
         codec="int8"))
CASES["buffered/duplicates"] = (
    _case(dict(algorithm="scaffold", round_driver="buffered",
               sample_with_replacement=True), sel=SEL_DUP),
    dict(algorithm="scaffold", round_driver="buffered",
         sample_with_replacement=True))
STREAM_DRIVERS = ("python", "scan", "buffered")
for _d in STREAM_DRIVERS:
    CASES[f"stream/{_d}"] = (
        _case(dict(algorithm="feddane", round_driver=_d,
                   client_source="streaming", num_devices=STREAM_N),
              data=("stream", STREAM_N), rounds=STREAM_ROUNDS), None)


@pytest.fixture(scope="module")
def p0():
    p = j_init_params(j_logreg_specs(60, 10), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def reference(p0):
    """The reference's unsharded run of every case that has one."""
    data = {n: j_make_synthetic(1, 1, num_devices=n, seed=0)
            for n in (N, 18)}
    out = {}
    for name, (case, jkw) in CASES.items():
        if jkw is None:
            continue
        kw = dict(KW, engine="loop", **jkw)
        tr = JTrainer(j_logreg_loss, data[kw["num_devices"]], JConfig(**kw))
        hist, final = tr.run(jax.tree_util.tree_map(jnp.asarray, p0),
                             case["rounds"], selections=case["sel"])
        out[name] = (hist, jax.tree_util.tree_map(np.asarray, final))
    return out


@pytest.fixture(scope="module")
def one_process(p0):
    """The port's single-process run of the cases held to it."""
    return {name: child.run_case(None, case, p0)
            for name, (case, jkw) in CASES.items() if jkw is None}


@pytest.fixture(scope="module")
def ranks(p0, tmp_path_factory):
    """mesh name -> the per-rank results of every case."""
    cases = {name: case for name, (case, _) in CASES.items()}
    out = {}
    for name, (d, e) in MESHES.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tempfile, "tempdir",
                       str(tmp_path_factory.mktemp(f"store_{name}")))
            res = sharding.run_on_mesh(child.run_cases, d, e, device="cpu",
                                       args=(cases, p0))
        assert [r["rank"] for r in res] == list(range(d))
        out[name] = res
    return out


def _close(got, want, atol):
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0.0)


def _hist(got, want, atol, skip=("loss",)):
    """The loss at ``atol``, every key of ``want`` but ``skip``
    exactly."""
    np.testing.assert_allclose(got["loss"], want["loss"], atol=atol)
    for k in want:
        if k not in skip:
            assert list(got[k]) == list(want[k]), k


def _got(ranks, mesh, name):
    return ranks[mesh][0]["cases"][name]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("algo", ALGOS)
def test_scan_mesh_matches_reference_scan(ranks, reference, mesh, algo):
    got = _got(ranks, mesh, f"scan/{algo}")
    hist, final = reference[f"scan/{algo}"]
    assert got["driver"] == "scan"
    _hist(got["hist"], hist, ATOL)
    _close(got["params"], final, ATOL)
    assert got["hist"]["sharded"] == [1.0] * ROUNDS


@pytest.mark.parametrize("mesh", list(MESHES))
def test_scan_mesh_replicates_an_indivisible_layout(ranks, reference,
                                                    mesh):
    """N=18 on 4 ranks: the all-client stacks replicated (cohorts still
    shard), the run within 1e-5 of the reference, ``sharded`` 0.0."""
    got = _got(ranks, mesh, "scan/scaffold_n18")
    hist, final = reference["scan/scaffold_n18"]
    _hist(got["hist"], hist, ATOL)
    _close(got["params"], final, ATOL)
    assert got["hist"]["sharded"] == [0.0] * ROUNDS


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scan_mesh_scenario_masks_are_the_references(ranks, reference,
                                                     mesh, scenario):
    got = _got(ranks, mesh, f"scan/{scenario}")
    hist, final = reference[f"scan/{scenario}"]
    cfg = JConfig(**dict(KW, algorithm="feddane", **SCENARIOS[scenario]))
    spec = jscn.scenario_spec(scenario)
    table = CASES[f"scan/{scenario}"][0]["env"]
    assert len(got["active"]) == len(got["avail"]) == ROUNDS
    for t in range(ROUNDS):
        u = {c: jnp.asarray(v[t]) for c, v in table.items()}
        t_f = jnp.float32(t)
        active = jscn.realize_env(spec, cfg, N, jnp.asarray(SEL[t, 1]), t_f,
                                  u).active
        avail = jscn.availability_mask(spec, cfg, N, jnp.asarray(SEL[t, 0]),
                                       t_f, u)
        assert np.array_equal(got["active"][t], np.asarray(active)), t
        assert np.array_equal(got["avail"][t], np.asarray(avail)), t
    assert got["hist"]["effective_k"] == hist["effective_k"]
    assert min(hist["effective_k"]) < K, "scenario inert"
    _hist(got["hist"], hist, ATOL)
    _close(got["params"], final, ATOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("codec", CODECS)
def test_scan_mesh_codec_matches_reference_scan(ranks, reference, mesh,
                                                codec):
    got = _got(ranks, mesh, f"scan/{codec}")
    hist, final = reference[f"scan/{codec}"]
    _hist(got["hist"], hist, CODEC_ATOL)
    _close(got["params"], final, CODEC_ATOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_scan_mesh_samples_as_one_process(ranks, one_process, mesh):
    """On-card sampling from each rank's generator under the seed: every
    selection bitwise the single-process scanned driver's."""
    got, want = _got(ranks, mesh, "scan/sampled"), one_process["scan/sampled"]
    assert len(got["sel"]) == len(want["sel"]) == 2 * ROUNDS
    for a, b in zip(got["sel"], want["sel"]):
        assert np.array_equal(a, b)
    _hist(got["hist"], want["hist"], ATOL, skip=("loss", "sharded"))
    _close(got["params"], want["params"], ATOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("algo", BUFFERED)
def test_buffered_mesh_matches_reference(ranks, reference, mesh, algo):
    """Degenerate (M = K, no latency): the reference's unsharded buffered
    driver's history and params."""
    got = _got(ranks, mesh, f"buffered/{algo}")
    hist, final = reference[f"buffered/{algo}"]
    assert got["driver"] == "buffered"
    _hist(got["hist"], hist, ATOL)
    _close(got["params"], final, ATOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_buffered_mesh_hostile_event_stream(ranks, reference, mesh):
    """``hostile``, M=5: refills of 1-3 clients pad to 4 rows; the event
    stream (selections, staleness, waits, times) is the reference's."""
    got = _got(ranks, mesh, "buffered/hostile")
    hist, final = reference["buffered/hostile"]
    assert set(TELEMETRY) <= set(hist)
    _hist(got["hist"], hist, ATOL)
    assert max(hist["staleness_max"]) > 0, "no stale update"
    _close(got["params"], final, ATOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_buffered_mesh_padded_buffer_with_int8(ranks, reference, mesh):
    """``buffer_size=6`` on 4 ranks: the commit buffer pads to 8 rows of
    weight 0; int8 fed the reference's draws."""
    got = _got(ranks, mesh, "buffered/int8_m6")
    hist, final = reference["buffered/int8_m6"]
    _hist(got["hist"], hist, CODEC_ATOL)
    _close(got["params"], final, CODEC_ATOL)
    assert np.isfinite(got["hist"]["loss"]).all()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_buffered_mesh_duplicates_in_occurrence_layers(ranks, reference,
                                                       mesh):
    got = _got(ranks, mesh, "buffered/duplicates")
    hist, final = reference["buffered/duplicates"]
    _hist(got["hist"], hist, ATOL)
    _close(got["params"], final, ATOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("driver", STREAM_DRIVERS)
def test_streaming_mesh_equals_one_process(ranks, one_process, mesh,
                                           driver):
    """A streaming source of N=1,000 on the mesh: the samplers' draws
    bitwise the single process's, params within 1e-5, and every rank
    generating fewer clients than the single process; on the python and
    scanned drivers at most the eval sample plus its K/D rows of each
    phase and round."""
    name = f"stream/{driver}"
    want = one_process[name]
    assert len(want["sel"]) > 0
    for r in ranks[mesh]:
        got = r["cases"][name]
        assert got["driver"] == driver
        assert len(got["sel"]) == len(want["sel"])
        for a, b in zip(got["sel"], want["sel"]):
            assert np.array_equal(a, b)
        _hist(got["hist"], want["hist"], ATOL, skip=("loss", "sharded"))
        _close(got["params"], want["params"], ATOL)
        assert got["materialized"] < want["materialized"]
        if driver != "buffered":
            bound = child.EVAL_CLIENTS + STREAM_ROUNDS * 2 * K // 4
            assert got["materialized"] <= bound, got["materialized"]
    if driver == "scan":
        assert ranks[mesh][0]["cases"][name]["hist"]["sharded"] == \
            [1.0] * STREAM_ROUNDS


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype, a.shape, a.tobytes()) == (b.dtype, b.shape,
                                                    b.tobytes())
    return a == b


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_driver_ranks_are_bitwise_equal(ranks, mesh):
    """Params, history and the recorded draws and masks of every case
    bitwise equal on every rank (the streaming counts aside: each rank
    generates its own rows)."""
    first = ranks[mesh][0]["cases"]
    for r in ranks[mesh][1:]:
        for case, res in r["cases"].items():
            a = {k: v for k, v in res.items() if k != "materialized"}
            b = {k: v for k, v in first[case].items() if k != "materialized"}
            assert _same(a, b), f"rank {r['rank']}: {case}"


@pytest.mark.parametrize("mesh", list(MESHES))
def test_auto_resolves_to_scan_on_a_mesh(ranks, mesh):
    """``round_driver="auto"`` on the mesh runs the scanned driver, as
    the reference resolves it wherever the engine is batched: the same
    run as ``"scan"``, bit for bit."""
    auto, scan = (_got(ranks, mesh, n) for n in ("scan/auto", "scan/sampled"))
    assert auto["driver"] == "scan"
    assert _same(auto["hist"], scan["hist"])
    assert _same(auto["params"], scan["params"])
