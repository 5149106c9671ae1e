"""The port's scanned driver against the JAX package's, on the CPU.

Mirrors tests/test_scan_driver.py (synthetic(0.5,0.5), N=8, K=4, E=2,
6 rounds, ``chunk_rounds=4``, ``eval_every=2``, injected selections),
with the reference's zero-initialised weights carried across by
``params_from_numpy``.  On the CPU the port's captured round runs
eagerly: the same body the card replays.

- **Parity**: for every algorithm, the port's ``round_driver="scan"``
  against the reference's ``ScannedDriver`` and against the port's
  python driver: ``round`` and ``comm_rounds`` equal, loss history and
  params at atol 1e-5 (the reference's own scan-parity bar: float32 sums
  run in another order in the two frameworks), the other history keys
  exactly.
- **Determinism**: each driver reproduces itself for a seed; chunk
  boundaries change nothing, bit for bit.
- **Scenarios**: under ``hostile`` the port realizes the environment
  from the reference's own uniforms (its scan carry's key chain,
  ``split(key, 1 + channels)`` a round from ``PRNGKey(seed)``, computed
  here and injected through ``engine.scan_env_uniforms``): the solve
  and phase-A masks equal the reference's interpreter on them bit for
  bit, the work fractions to an ulp (XLA's own eager and compiled values
  differ by one), and ``effective_k`` equals the reference scan's
  history exactly.
- **Codecs**: the lossy codecs with the reference's codec draws (the
  port's ``codecs.round_draws`` replaced, as tests/test_torch_codecs.py
  does), error feedback carried in the driver across chunks: atol 1e-4,
  the reference's cross-path bar for lossy codecs.
"""
import os
from typing import Dict

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
from repro.core import engine as jengine
from repro.core import scenarios as jscn
from repro.data import make_synthetic as j_make_synthetic
from repro.models.param import init_params as j_init_params
from repro.models.small import logreg_loss as j_logreg_loss
from repro.models.small import logreg_specs as j_logreg_specs
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer, ScannedDriver, make_scanned_run
from repro_torch.core import codecs as tcodecs
from repro_torch.core import engine as t_engine
from repro_torch.core import pytree as pt
from repro_torch.data import make_synthetic
from repro_torch.kernels.flatpack import LANES
from repro_torch.models.param import params_from_numpy, params_to_numpy
from repro_torch.models.small import logreg_loss

ALGOS = ["fedavg", "fedprox", "feddane", "inexact_dane",
         "feddane_pipelined", "feddane_decayed", "scaffold",
         "fedavgm", "sdane"]
NUM_ROUNDS = 6
ATOL = 1e-5
N, K = 8, 4
BASE_KW = dict(num_devices=N, devices_per_round=K, local_epochs=2,
               learning_rate=0.05, mu=0.01, seed=7, correction_decay=0.9)
#: Knobs that make every process of ``hostile`` bite at N=8, K=4.
HOSTILE = dict(scenario="hostile", avail_prob=0.6, dropout_rate=0.3,
               straggler_deadline=1.2, straggler_sigma=0.8,
               partial_min_work=0.3)


@pytest.fixture(scope="module")
def setup():
    jds = j_make_synthetic(0.5, 0.5, num_devices=N, seed=2)
    tds = make_synthetic(0.5, 0.5, num_devices=N, seed=2, device="cpu")
    p0 = j_init_params(j_logreg_specs(60, 10), jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    # (rounds, 2 phases, K) fixed selection sequence, no replacement
    sel = np.stack([
        np.stack([rng.choice(N, K, replace=False) for _ in range(2)])
        for _ in range(NUM_ROUNDS)])
    return jds, tds, jax.tree_util.tree_map(np.asarray, p0), sel


def _kw(algo, driver, **over):
    kw = dict(BASE_KW, algorithm=algo, round_driver=driver, engine="loop",
              chunk_rounds=4)
    kw.update(over)
    return kw


_REF = {}


def _reference(setup, algo, **over):
    """The reference's scanned run (cached per config)."""
    key = (algo, tuple(sorted(over.items())))
    if key not in _REF:
        jds, _, p0, sel = setup
        tr = JTrainer(j_logreg_loss, jds, JConfig(**_kw(algo, "scan", **over)))
        _REF[key] = tr.run(jax.tree_util.tree_map(jnp.asarray, p0),
                           NUM_ROUNDS, eval_every=2, selections=sel)
    return _REF[key]


def _port(setup, algo, driver="scan", sel=True, checkpoint_dir=None,
          **over):
    _, tds, p0, selections = setup
    tr = FederatedTrainer(logreg_loss, tds,
                          FederatedConfig(**_kw(algo, driver, **over)),
                          device="cpu")
    return tr.run(params_from_numpy(p0, device="cpu"), NUM_ROUNDS,
                  eval_every=2, selections=selections if sel else None,
                  checkpoint_dir=checkpoint_dir)


def _close(got, want, atol=ATOL):
    g = pt.leaves(params_to_numpy(got))
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


def _hist_match(got, want, atol=ATOL):
    assert got.keys() == want.keys()
    for k in want:
        if k == "loss":
            np.testing.assert_allclose(got[k], want[k], atol=atol)
        else:
            assert list(got[k]) == list(want[k]), k


def _bitwise(p1, p2):
    for a, b in zip(pt.leaves(p1), pt.leaves(p2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("algo", ALGOS)
def test_scan_matches_reference_scan(setup, algo):
    """The port's scanned driver against the reference's, injected
    selections: the same history, params at atol 1e-5."""
    jh, jp = _reference(setup, algo)
    th, tp = _port(setup, algo)
    assert th["round"] == [1, 3, 5, 6]
    _hist_match(th, jh)
    _close(tp, jp)


@pytest.mark.parametrize("algo", ALGOS)
def test_scan_matches_python_driver(setup, algo):
    """The port's two drivers on the same selections."""
    ph, pp = _port(setup, algo, "python")
    sh, sp = _port(setup, algo, "scan")
    assert ph["round"] == sh["round"]
    assert ph["comm_rounds"] == sh["comm_rounds"]
    _hist_match(sh, ph)
    _close(sp, params_to_numpy(pp))


@pytest.mark.parametrize("driver", ["python", "scan"])
def test_driver_individually_reproducible(setup, driver):
    """A fixed seed gives that driver the same selections, history and
    params run after run (the drivers' selections differ: another bit
    stream, the same distribution)."""
    (h1, p1), (h2, p2) = [_port(setup, "feddane", driver, sel=False)
                          for _ in range(2)]
    assert h1 == h2
    _bitwise(p1, p2)


def test_driver_object_reproducible_across_runs(setup):
    """One ScannedDriver run twice from the same params: the generator
    is re-seeded at every run, so the second run repeats the first."""
    _, tds, p0, _ = setup
    drv = ScannedDriver(logreg_loss, tds,
                        FederatedConfig(**_kw("feddane", "scan")))
    (h1, p1), (h2, p2) = [drv.run(params_from_numpy(p0, device="cpu"),
                                  NUM_ROUNDS) for _ in range(2)]
    assert h1 == h2
    _bitwise(p1, p2)


def test_chunk_boundaries_do_not_change_results(setup):
    h1, p1 = _port(setup, "fedprox", chunk_rounds=2)
    h2, p2 = _port(setup, "fedprox", chunk_rounds=6)
    assert h1 == h2
    _bitwise(p1, p2)


def test_checkpoints_at_chunk_boundaries(setup, tmp_path):
    """Saves at the reference's rounds under its file names; each holds
    the reference's params (atol 1e-5) and round, and its bytes are
    exactly what the reference's store writes for the port's tree."""
    _, tds, p0, sel = setup
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    JTrainer(j_logreg_loss, setup[0],
             JConfig(**_kw("fedavg", "scan"))).run(
        jax.tree_util.tree_map(jnp.asarray, p0), NUM_ROUNDS,
        eval_every=2, selections=sel, checkpoint_dir=jdir)
    _, p = _port(setup, "fedavg", checkpoint_dir=tdir)
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) == [
        "ckpt_00000004.msgpack", "ckpt_00000006.msgpack"]
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
    _bitwise(last["params"], p)


def test_scaffold_with_replacement_falls_back_to_python(setup):
    _, tds, p0, _ = setup
    kw = dict(BASE_KW, algorithm="scaffold", round_driver="scan",
              sample_with_replacement=True)
    tr = FederatedTrainer(logreg_loss, tds, FederatedConfig(**kw),
                          device="cpu")
    hist, _ = tr.run(params_from_numpy(p0, device="cpu"), 2)
    assert tr._scanned is None           # the scanned driver never built
    assert len(hist["loss"]) == 2
    with pytest.raises(ValueError, match="sample_with_replacement"):
        ScannedDriver(logreg_loss, tds, FederatedConfig(**kw))


def test_selections_must_cover_num_rounds(setup):
    _, tds, p0, sel = setup
    for driver in ("python", "scan"):
        tr = FederatedTrainer(logreg_loss, tds,
                              FederatedConfig(**_kw("fedavg", driver)),
                              device="cpu")
        with pytest.raises(ValueError, match="selections covers"):
            tr.run(params_from_numpy(p0, device="cpu"), NUM_ROUNDS,
                   selections=sel[:2])


def test_make_scanned_run_factory(setup):
    """The factory's driver runs the sampled program end to end, with a
    two-dimensional injected selection broadcast to both phases too."""
    _, tds, p0, sel = setup
    cfg = FederatedConfig(algorithm="fedavg", round_driver="scan",
                          chunk_rounds=0, **BASE_KW)
    driver = make_scanned_run(logreg_loss, tds, cfg)
    hist, _ = driver.run(params_from_numpy(p0, device="cpu"), 3,
                         eval_every=1)
    assert len(hist["loss"]) == 3 and all(np.isfinite(hist["loss"]))
    assert hist["comm_rounds"] == [1, 2, 3]
    h2, _ = driver.run(params_from_numpy(p0, device="cpu"), 3,
                       selections=sel[:3, 0])
    h3, _ = driver.run(params_from_numpy(p0, device="cpu"), 3,
                       selections=sel[:3, [0, 0]])
    assert h2 == h3


# -- scenarios: the reference's uniforms ------------------------------------

def reference_env_uniforms(cfg, rounds: int, n: int):
    """The uniforms the reference's scanned driver draws with injected
    selections: ``split(key, 1 + channels)`` a round from
    ``PRNGKey(seed)``, one ``(n,)`` float32 uniform per channel."""
    channels = jscn.env_channels(jscn.scenario_spec(cfg.scenario))
    key = jax.random.PRNGKey(cfg.seed)
    out = {c: [] for c in channels}
    for _ in range(rounds):
        keys = jax.random.split(key, 1 + len(channels))
        key = keys[0]
        for c, ek in zip(channels, keys[1:]):
            out[c].append(np.asarray(jax.random.uniform(ek, (n,))))
    return {c: np.stack(v) for c, v in out.items()}


def record_chunk_work(monkeypatch) -> Dict[int, np.ndarray]:
    """Make the reference's scanned driver report, from inside its
    compiled chunk, the ``work`` each round's ``realize_env`` realizes
    (a ``jax.debug.callback``, keyed by the round index); returns the
    dict it fills."""
    got: Dict[int, np.ndarray] = {}
    realize = jengine.realize_env

    def spy(spec, cfg, n, sel, t, uniforms):
        env = realize(spec, cfg, n, sel, t, uniforms)
        jax.debug.callback(
            lambda t_, w: got.__setitem__(int(t_), np.asarray(w)), t,
            env.work, ordered=True)
        return env

    monkeypatch.setattr(jengine, "realize_env", spy)
    return got


@pytest.mark.parametrize("algo", ["feddane", "fedavg"])
def test_hostile_matches_reference_scan(setup, monkeypatch, algo):
    """``hostile`` with the reference's uniforms: every round's
    ``active`` and phase-A availability mask equal the reference's
    interpreter on the same draws bit for bit, ``work`` equals what the
    reference's compiled chunk realizes bit for bit, effective K equals
    the reference scan's exactly, params at 1e-5."""
    _, _, _, sel = setup
    jcfg = JConfig(**_kw(algo, "scan", **HOSTILE))
    table = reference_env_uniforms(jcfg, NUM_ROUNDS, N)
    tables = {c: torch.from_numpy(v) for c, v in table.items()}
    monkeypatch.setattr(
        t_engine, "scan_env_uniforms",
        lambda gen, channels, n, t: {c: tables[c].index_select(0, t)[0]
                                     for c in channels})
    envs, avails = [], []
    realize, avail = t_engine.realize_env_staged, \
        t_engine.availability_mask_staged

    def spy_env(*a):
        env = realize(*a)
        envs.append((env.active.clone(), env.work.clone()))
        return env

    def spy_avail(*a):
        m = avail(*a)
        avails.append(m.clone())
        return m

    monkeypatch.setattr(t_engine, "realize_env_staged", spy_env)
    monkeypatch.setattr(t_engine, "availability_mask_staged", spy_avail)
    chunk_work = record_chunk_work(monkeypatch)
    th, tp = _port(setup, algo, **HOSTILE)
    _REF.pop((algo, tuple(sorted(HOSTILE.items()))), None)
    jh, jp = _reference(setup, algo, **HOSTILE)
    assert th["effective_k"] == jh["effective_k"]
    assert min(th["effective_k"]) < K          # the masks bite
    _hist_match(th, jh)
    _close(tp, jp)
    spec = jscn.scenario_spec("hostile")
    two = algo == "feddane"
    assert len(envs) == NUM_ROUNDS and len(avails) == (NUM_ROUNDS * two)
    for r in range(NUM_ROUNDS):
        u = {c: jnp.asarray(v[r]) for c, v in table.items()}
        s1, s2 = jnp.asarray(sel[r, 0]), jnp.asarray(sel[r, 1])
        t_f = jnp.float32(r)
        env = jscn.realize_env(spec, jcfg, N, s2 if two else s1, t_f, u)
        assert np.array_equal(envs[r][0].numpy(), np.asarray(env.active))
        # the work fraction is a product with partial_work's linspace,
        # which XLA evaluates differently eagerly and compiled (at N=8,
        # min work 0.3: 0.4 and 0.40000004); the reference's chunk
        # computes it compiled, and so does the port's scanned driver
        assert np.array_equal(envs[r][1].numpy().view(np.int32),
                              chunk_work[r].view(np.int32))
        if two:
            want = jscn.availability_mask(spec, jcfg, N, s1, t_f, u)
            assert np.array_equal(avails[r].numpy(), np.asarray(want))


# -- codecs: the reference's draws ------------------------------------------

def reference_draws(spec, cfg, t, k, rows, device="cpu", idx0=0):
    """The reference's codec draws of round ``t`` (its ``round_key`` and
    ``fold_in`` constants) in the port's ``CodecDraws`` form."""
    if not spec.uses_rng:
        return None
    key = jcodecs.round_key(cfg, t)
    signs = jax.random.rademacher(jax.random.fold_in(key, 0x5167), (LANES,),
                                  dtype=jnp.float32)
    u = jnp.stack([jax.random.uniform(jax.random.fold_in(key, idx0 + i),
                                      (rows, LANES)) for i in range(k)])
    noise = jax.random.normal(jax.random.fold_in(key, 0x0D99),
                              (rows, LANES))
    return tcodecs.CodecDraws(*(torch.from_numpy(np.array(a)).to(device)
                                for a in (signs, u, noise)))


@pytest.mark.parametrize("codec", ["int8", "topk", "dp_gauss"])
def test_lossy_codec_matches_reference_scan(setup, monkeypatch, codec):
    """feddane with each lossy codec, the reference's draws injected:
    params and loss at 1e-4, wire bytes exactly; topk's error feedback
    rides the driver's carry across the chunk boundary."""
    monkeypatch.setattr(tcodecs, "round_draws", reference_draws)
    jh, jp = _reference(setup, "feddane", codec=codec)
    th, tp = _port(setup, "feddane", codec=codec)
    _hist_match(th, jh, atol=1e-4)
    _close(tp, jp, atol=1e-4)
