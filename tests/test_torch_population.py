"""The port's population layer against the JAX package's, on the CPU.

Mirrors tests/test_population.py (a ``make_synthetic_stream(0.5, 0.5)``
source at N=12, K=4, 3 rounds, seed 5) with the reference's own
sources, drivers and zero-initialised weights beside the port's:

- **the source**: every generated array, padded batch stack and eval id
  of ``repro_torch.data.shard_source`` bitwise equal to
  ``repro.data.shard_source``'s, for both generators;
- **streaming equals dense**: every algorithm over the source matches
  the same run over ``source.materialize()`` on the python driver
  (both engines) and the buffered driver, at atol 1e-5;
- **streaming equals stacked** on the scanned driver, with its own
  sampled selections: the selections bit for bit, params and losses at
  1e-5, for the 8 sampled algorithms and under ``bernoulli``;
- **the port against the reference**: each driver's streaming run
  against the reference's, on injected selections, 3 rounds at 1e-5;
- source telemetry, the sparse store against a dense carry (property
  tests), the bounded dense eval sample;
- **the N=10^6 memory gate** in a fresh interpreter
  (tests/_torch_population_child.py): peak RSS under 1.5 GB and the
  reference's telemetry bounds;
- **the paper's finding** at K/N = 1e-5 under ``bernoulli``: FedDANE's
  loss over 1.5x FedAvg's and FedProx's after 4 scanned rounds.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypo_fallback import given, settings, strategies as st

from repro.configs.base import FederatedConfig as JConfig
from repro.core import FederatedTrainer as JTrainer
from repro.data import shard_source as jsrc
from repro.models.param import init_params as j_init_params
from repro.models.small import logreg_loss as j_logreg_loss
from repro.models.small import logreg_specs as j_logreg_specs
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer
from repro_torch.core import pytree as pt
from repro_torch.core import server as t_server
from repro_torch.core.client_state import SparseClientState
from repro_torch.data import (FederatedData, make_synthetic_stream,
                              resolve_streaming)
from repro_torch.data.batching import stack_eval_batches
from repro_torch.models.param import params_from_numpy, params_to_numpy
from repro_torch.models.small import logreg_loss

ALGOS = ["fedavg", "fedavgm", "feddane", "feddane_decayed",
         "feddane_pipelined", "fedprox", "inexact_dane", "one_shot",
         "scaffold", "sdane"]
#: algorithms with a sampled cohort (the streaming scan plan; the two
#: full-participation specs take the stacked plan by design)
SAMPLED = [a for a in ALGOS if a not in ("inexact_dane", "one_shot")]
ATOL = 1e-5
N, K, R = 12, 4, 3
BASE = dict(num_devices=N, devices_per_round=K, local_epochs=1,
            local_batch_size=10, learning_rate=0.05, mu=0.01, seed=5,
            correction_decay=0.9)


@pytest.fixture(scope="module")
def setup():
    src = make_synthetic_stream(0.5, 0.5, num_devices=N, seed=3,
                                device="cpu")
    jsource = jsrc.make_synthetic_stream(0.5, 0.5, num_devices=N, seed=3)
    p0 = jax.tree_util.tree_map(
        np.asarray, j_init_params(j_logreg_specs(60, 10),
                                  jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    sel = np.stack([np.stack([rng.choice(N, size=K, replace=False)
                              for _ in range(2)]) for _ in range(R)])
    return src, src.materialize(), jsource, p0, sel


def _run(ds, p0, sel=None, **kw):
    cfg = FederatedConfig(**{**BASE, **kw})
    tr = FederatedTrainer(logreg_loss, ds, cfg, device="cpu")
    return tr.run(params_from_numpy(p0, device="cpu"), R, eval_every=1,
                  selections=sel)


def _jrun(ds, p0, sel=None, **kw):
    tr = JTrainer(j_logreg_loss, ds, JConfig(**{**BASE, **kw}))
    return tr.run(jax.tree_util.tree_map(jnp.asarray, p0), R,
                  eval_every=1, selections=sel)


def _leaves(p):
    if isinstance(next(iter(pt.leaves(p))), torch.Tensor):
        return pt.leaves(params_to_numpy(p))
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(p)]


def _assert_parity(a, b):
    np.testing.assert_allclose(a[0]["loss"], b[0]["loss"], atol=ATOL)
    la, lb = _leaves(a[1]), _leaves(b[1])
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, atol=ATOL)


# -- 1. the source, bitwise -------------------------------------------------

SOURCES = {
    "synthetic": (lambda m, **kw: m.make_synthetic_stream(0.5, 0.5, **kw)),
    "synthetic_iid": (lambda m, **kw: m.make_synthetic_stream(
        1.0, 1.0, iid=True, **kw)),
    "femnist": (lambda m, **kw: m.make_femnist_stream(**kw)),
}


@pytest.mark.parametrize("k", [0, 7, 31_337, 999_999])
@pytest.mark.parametrize("kind", sorted(SOURCES))
def test_source_arrays_match_reference(kind, k):
    """Client k's raw arrays, its padded batch stack and its size equal
    the reference source's bit for bit (N=10^6: nothing else is
    generated)."""
    import repro_torch.data.shard_source as tsrc
    kw = dict(num_devices=1_000_000, seed=4)
    mine = SOURCES[kind](tsrc, device="cpu", **kw)
    ref = SOURCES[kind](jsrc, **kw)
    a, b = mine._client_arrays(k), ref._client_arrays(k)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype
        assert np.array_equal(a[key], b[key]), key
    ba, bb = mine.device_batches(k), ref.device_batches(k)
    for key in bb:
        assert np.array_equal(ba[key].numpy(), np.asarray(bb[key])), key
    assert mine.size_of(k) == ref.size_of(k)
    assert mine.stats() == ref.stats()


@pytest.mark.parametrize("n,evals", [(12, 64), (12, 5), (1_000_000, 32)])
def test_eval_ids_match_reference(n, evals):
    mine = make_synthetic_stream(num_devices=n, seed=9, eval_clients=evals,
                                 device="cpu")
    ref = jsrc.make_synthetic_stream(num_devices=n, seed=9,
                                     eval_clients=evals)
    assert np.array_equal(mine.eval_ids(), ref.eval_ids())
    got = [(w, b["y"].numpy()) for w, b in mine.eval_batches()]
    want = [(w, np.asarray(b["y"])) for w, b in ref.eval_batches()]
    assert [w for w, _ in got] == [w for w, _ in want]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(got, want))


def test_materialize_is_the_dense_container(setup):
    src, dense, _, _, _ = setup
    assert isinstance(dense, FederatedData) and dense.num_devices == N
    for k in range(N):
        for key, x in src.device_batches(k).items():
            assert torch.equal(x, dense.device_batches(k)[key])
    assert src.weights is None and resolve_streaming("auto", src)
    assert not resolve_streaming("auto", dense)
    assert not resolve_streaming("stacked", src)


# -- 2. streaming equals dense, every driver ---------------------------------

@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_python_streaming_matches_dense(setup, engine, algo):
    """The python driver over the source == over its materialization
    (uniform sampling on both: the same host rng)."""
    src, dense, _, p0, _ = setup
    kw = dict(algorithm=algo, engine=engine, round_driver="python",
              weighted_sampling=False)
    _assert_parity(_run(src, p0, **kw), _run(dense, p0, **kw))


@pytest.mark.parametrize("algo", ALGOS)
def test_buffered_streaming_matches_dense(setup, algo):
    """The buffered driver over the source == over the dense container
    (constant staleness; the same uniform sampling)."""
    src, dense, _, p0, _ = setup
    kw = dict(algorithm=algo, round_driver="buffered",
              staleness_fn="constant", weighted_sampling=False)
    _assert_parity(_run(src, p0, **kw), _run(dense, p0, **kw))


def _scan_pair(monkeypatch, src, p0, sel=None, **kw):
    """The scanned driver streaming and stacked on ``src``, with the
    selections each round used: the stacked plan's sampler draws in
    order, and the streaming schedule's staged rows (a truncated chunk's
    redrawn round counts once)."""
    from repro_torch.core import engine as t_engine
    drawn, staged = [], []
    sample = t_server.sample_devices_onchip
    stage = t_engine.ScannedDriver._stream_stage

    def spy_sample(*a, **k):
        s = sample(*a, **k)
        drawn.append(s.clone())
        return s

    def spy_stage(self, off, rows, wire_rows):
        two = self.spec.num_selections == 2
        for r in rows:
            staged.extend([torch.from_numpy(r["s1"])]
                          + ([torch.from_numpy(r["sel_solve"])] if two
                             else []))
        return stage(self, off, rows, wire_rows)

    monkeypatch.setattr(t_engine.ScannedDriver, "_stream_stage", spy_stage)
    a = _run(src, p0, sel=sel, client_source="streaming", **kw)
    monkeypatch.setattr(t_server, "sample_devices_onchip", spy_sample)
    b = _run(src, p0, sel=sel, client_source="stacked", **kw)
    return a, b, staged, drawn


@pytest.mark.parametrize("algo", SAMPLED)
def test_scan_streaming_matches_stacked(setup, monkeypatch, algo):
    """The scanned driver's streaming plan (schedule pass, staged
    cohorts, sparse stores) against its stacked plan on the SAME source,
    with sampled selections: the draws bit for bit, params at 1e-5."""
    src, _, _, p0, _ = setup
    a, b, ds, dt = _scan_pair(monkeypatch, src, p0, algorithm=algo,
                              engine="batched", round_driver="scan",
                              chunk_rounds=R)
    assert len(ds) == len(dt) > 0
    assert all(torch.equal(x, y) for x, y in zip(ds, dt))
    _assert_parity(a, b)


@pytest.mark.parametrize("algo", ["feddane", "scaffold"])
def test_scan_streaming_matches_stacked_bernoulli(setup, monkeypatch, algo):
    """The environment's uniforms are part of the schedule: streaming ==
    stacked under ``bernoulli`` too, ``effective_k`` exactly."""
    src, _, _, p0, _ = setup
    a, b, ds, dt = _scan_pair(monkeypatch, src, p0, algorithm=algo,
                              engine="batched", round_driver="scan",
                              chunk_rounds=R, scenario="bernoulli",
                              avail_prob=0.7)
    assert all(torch.equal(x, y) for x, y in zip(ds, dt))
    assert a[0]["effective_k"] == b[0]["effective_k"]
    assert min(a[0]["effective_k"]) < K
    _assert_parity(a, b)


@pytest.mark.parametrize("algo", ["feddane", "scaffold"])
def test_scan_streaming_matches_dense_injected(setup, algo):
    """Injected selections: streaming over the source == the stacked
    plan over the materialized container."""
    src, dense, _, p0, sel = setup
    kw = dict(algorithm=algo, engine="batched", round_driver="scan",
              chunk_rounds=R, weighted_sampling=False)
    _assert_parity(_run(src, p0, sel=sel, client_source="streaming", **kw),
                   _run(dense, p0, sel=sel, client_source="stacked", **kw))


def test_scaffold_chunk_stops_at_a_repeated_client(setup):
    """A stateful spec's streaming chunk ends before a round whose cohort
    repeats a client; the state rows it scatters back are the stacked
    plan's (the stores equal the dense controls)."""
    src, _, _, p0, _ = setup
    sel = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [1, 8, 9, 10]])
    cfg = FederatedConfig(**{**BASE, "algorithm": "scaffold",
                             "engine": "batched", "round_driver": "scan",
                             "chunk_rounds": R})
    tr = FederatedTrainer(logreg_loss, src, cfg, device="cpu")
    tr.run(params_from_numpy(p0, device="cpu"), R, selections=sel)
    drv = tr._scanned
    assert drv.streaming and len(drv.controls_store) == 11
    ref = FederatedTrainer(
        logreg_loss, src, FederatedConfig(**{**BASE, "algorithm":
                                             "scaffold", "engine": "batched",
                                             "round_driver": "scan",
                                             "client_source": "stacked",
                                             "chunk_rounds": R}),
        device="cpu")
    ref.run(params_from_numpy(p0, device="cpu"), R, selections=sel)
    dense = ref._scanned._carry["controls"]
    for k in range(N):
        for x, y in zip(pt.leaves(drv.controls_store[k]),
                        pt.leaves(pt.index(dense, k))):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=ATOL)


def test_loop_injected_selections_match(setup):
    """Injected selections bypass sampling, so the source and the dense
    container (weighted or not) coincide."""
    src, dense, _, p0, sel = setup
    kw = dict(algorithm="feddane", engine="loop", round_driver="python")
    _assert_parity(_run(src, p0, sel=sel, **kw),
                   _run(dense, p0, sel=sel, **kw))


def test_streaming_requires_streaming_dataset(setup):
    _, dense, _, p0, _ = setup
    with pytest.raises(ValueError, match="streaming"):
        _run(dense, p0, algorithm="fedavg", engine="batched",
             round_driver="scan", client_source="streaming")


def test_measure_dissimilarity_refuses_a_stream(setup):
    """The theory instrumentation reads every client's gradient and
    p_k: O(N) and undefined on a source, so it raises there."""
    src, dense, _, p0, _ = setup
    cfg = FederatedConfig(**BASE)
    with pytest.raises(ValueError, match="streaming source"):
        FederatedTrainer(logreg_loss, src, cfg, device="cpu") \
            .measure_dissimilarity(params_from_numpy(p0, device="cpu"))
    FederatedTrainer(logreg_loss, dense, cfg, device="cpu") \
        .measure_dissimilarity(params_from_numpy(p0, device="cpu"))


# -- 3. the port against the reference ---------------------------------------

DRIVERS = {"python": dict(engine="batched", round_driver="python"),
           "buffered": dict(round_driver="buffered",
                            staleness_fn="constant"),
           "scan": dict(engine="batched", round_driver="scan",
                        chunk_rounds=R)}


@pytest.mark.parametrize("driver,algo",
                         [(d, a) for d in ("python", "buffered")
                          for a in ALGOS]
                         + [("scan", a) for a in SAMPLED])
def test_streaming_matches_reference(setup, driver, algo):
    """The port's streaming run against the reference's, on each
    driver, with injected selections: 3 rounds at 1e-5, the same
    source data (bitwise, test 1) and zero weights."""
    src, _, jsource, p0, sel = setup
    kw = dict(algorithm=algo, weighted_sampling=False, **DRIVERS[driver])
    if driver == "scan":
        kw["client_source"] = "streaming"
    _assert_parity(_run(src, p0, sel=sel, **kw),
                   _jrun(jsource, p0, sel=sel, **kw))


# -- 4. telemetry, the sparse store, the dense eval sample -------------------

def test_source_telemetry_counts_cohorts(setup):
    """After a small run every client is generated at most once (N=12 <
    eval sample), and the cache telemetry is live."""
    _, _, _, p0, _ = setup
    src = make_synthetic_stream(0.5, 0.5, num_devices=N, seed=9,
                                device="cpu")
    _run(src, p0, algorithm="feddane", engine="loop",
         round_driver="python", weighted_sampling=False)
    s = src.stats()
    assert s["materialized_clients"] == N
    assert s["peak_cache_bytes"] > 0
    assert s["cached_clients"] <= N


def test_source_cache_evicts_and_regenerates():
    src = make_synthetic_stream(num_devices=100, seed=1, cache_clients=2,
                                device="cpu")
    first = src.device_batches(5)["x"].clone()
    for k in (6, 7, 8):
        src.device_batches(k)
    assert src.stats()["cached_clients"] == 2
    assert torch.equal(src.device_batches(5)["x"], first)
    assert src.materialized_clients == 5
    assert src.cache_bytes <= src.peak_cache_bytes


def _tmpl():
    return {"a": torch.zeros(2), "b": torch.zeros(())}


def _fill(v):
    return pt.tmap(lambda x: torch.full_like(x, float(np.float32(v))),
                   _tmpl())


@st.composite
def _op_seqs(draw):
    n = draw(st.integers(2, 10))
    ops = []
    for _ in range(draw(st.integers(0, 24))):
        kind = draw(st.sampled_from(["set", "evict", "scatter", "get"]))
        if kind == "set":
            ops.append(("set", draw(st.integers(0, n - 1)),
                        draw(st.floats(-2.0, 2.0))))
        elif kind == "evict":
            ops.append(("evict", draw(st.integers(0, n - 1))))
        elif kind == "scatter":
            ids = draw(st.lists(st.integers(0, n - 1), min_size=1,
                                max_size=4))
            vals = [draw(st.floats(-2.0, 2.0)) for _ in ids]
            ops.append(("scatter", ids, vals))
        else:
            ops.append(("get", draw(st.integers(0, n - 1))))
    return n, ops


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(pt.leaves(a),
                                                 pt.leaves(b)))


@settings(max_examples=25, deadline=None)
@given(_op_seqs())
def test_sparse_store_matches_dense_carry(case):
    """Any interleaving of reads, writes, evictions and stacked scatters
    (duplicate ids included) gives exactly the dense length-N carry,
    storing only touched rows."""
    n, ops = case
    sp = SparseClientState(n, _tmpl())
    dense = [_tmpl() for _ in range(n)]
    touched = set()
    for op in ops:
        if op[0] == "set":
            sp[op[1]] = _fill(op[2])
            dense[op[1]] = _fill(op[2])
            touched.add(op[1])
        elif op[0] == "evict":
            sp.evict(op[1])
            dense[op[1]] = _tmpl()
        elif op[0] == "scatter":
            _, ids, vals = op
            sp.scatter(ids, pt.stack([_fill(v) for v in vals]))
            for k, v in zip(ids, vals):
                dense[k] = _fill(v)
            touched.update(ids)
        else:
            assert _same(sp[op[1]], dense[op[1]])
    for a, b in zip(sp.to_dense(), dense):
        assert _same(a, b)
    assert _same(sp.gather(range(n)), pt.stack(dense))
    assert len(sp) <= len(touched) and sp.peak_clients <= len(touched)


def test_sparse_store_bounds_ids_and_peak():
    sp = SparseClientState(4, _tmpl())
    with pytest.raises(IndexError):
        sp[4]
    with pytest.raises(IndexError):
        sp[-1] = _fill(1.0)
    sp[2] = _fill(1.0)
    sp[3] = _fill(2.0)
    sp.evict(2)
    assert len(sp) == 1 and sp.peak_clients == 2
    assert _same(sp[2], _tmpl())


def test_dense_eval_sample_is_bounded_and_deterministic(setup):
    src = setup[0]
    data = [src._client_arrays(k) for k in range(N)]
    a = FederatedData(data, batch_size=10, eval_sample=4, eval_seed=1,
                      device="cpu")
    b = FederatedData(data, batch_size=10, eval_sample=4, eval_seed=1,
                      device="cpu")
    assert len(a.eval_ids()) == 4
    assert np.array_equal(a.eval_ids(), b.eval_ids())
    assert len(list(a.eval_batches())) == 4
    _, valid, w = stack_eval_batches(a)
    assert valid.shape[0] == 4 and w.shape == (4,)


def test_dense_eval_sample_full_coverage_is_dense(setup):
    """eval_sample >= N is the exact all-N eval."""
    src, dense, _, p0, _ = setup
    data = [src._client_arrays(k) for k in range(N)]
    full = FederatedData(data, batch_size=10, eval_sample=N + 5,
                         device="cpu")
    p = params_from_numpy(p0, device="cpu")
    cfg = FederatedConfig(algorithm="fedavg", **BASE)
    a = FederatedTrainer(logreg_loss, dense, cfg, device="cpu")
    b = FederatedTrainer(logreg_loss, full, cfg, device="cpu")
    assert a.global_loss(p) == pytest.approx(b.global_loss(p), abs=1e-6)


# -- 5. population scale -----------------------------------------------------

def test_population_memory_regression():
    """Fresh interpreter: 3 feddane rounds at N=1,000,000, K=10 on the
    python and scanned drivers plus 2 scaffold rounds; peak RSS and all
    telemetry at cohort scale."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(root, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, os.path.join(root, "tests",
                                      "_torch_population_child.py")],
        capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["peak_rss_mb"] < 1500, out
    for run in ("feddane_python", "feddane_scan"):
        d = out[run]
        assert all(np.isfinite(d["loss"])), (run, d)
        # the eval sample (32) and two phases x K x R cohort fetches
        assert d["materialized_clients"] <= 32 + 2 * 10 * 3, (run, d)
        assert d["peak_cache_bytes"] < 64e6, (run, d)
    sc = out["scaffold"]
    assert sc["peak_clients"] <= 2 * 10, sc
    assert sc["stored_controls"] <= 2 * 10, sc


def test_population_directional_feddane_underperforms():
    """The paper's finding at K/N = 1e-5 under ``bernoulli``: FedDANE's
    stale aggregate gradient degrades while FedAvg and FedProx keep
    descending (4 rounds on the scanned driver's streaming plan)."""
    n, k, rounds = 1_000_000, 10, 4
    src = make_synthetic_stream(1.0, 1.0, num_devices=n, seed=7,
                                eval_clients=32, device="cpu")
    p0 = params_from_numpy({"b": np.zeros(10, np.float32),
                            "w": np.zeros((60, 10), np.float32)},
                           device="cpu")
    finals = {}
    for algo in ("fedavg", "fedprox", "feddane"):
        cfg = FederatedConfig(
            algorithm=algo, num_devices=n, devices_per_round=k,
            local_epochs=1, local_batch_size=10, learning_rate=0.05,
            mu=0.01, seed=5, engine="batched", round_driver="scan",
            chunk_rounds=rounds, scenario="bernoulli")
        tr = FederatedTrainer(logreg_loss, src, cfg, device="cpu")
        hist, _ = tr.run(p0, rounds, eval_every=rounds)
        finals[algo] = hist["loss"][-1]
    assert finals["feddane"] > 1.5 * finals["fedavg"], finals
    assert finals["feddane"] > 1.5 * finals["fedprox"], finals
