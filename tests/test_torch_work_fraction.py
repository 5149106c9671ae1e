"""Fault F4: ``partial_work``'s linspace work fractions, bit for bit.

``hostile`` and ``partial_work`` give device k the work fraction
``jnp.linspace(partial_min_work, 1.0, N)[k]``, which caps its local
steps at ``min(total, ceil(work * total))``, so one ulp can move a
client's step count.  XLA:CPU evaluates that linspace two ways: eagerly
(the reference's python and buffered drivers, and its streaming
schedule) and constant-folded into a compiled program (its scanned
driver's chunk, where the linspace is a loop-invariant fusion of its
own).  ``scenarios.builtin._xla_linspace`` reproduces both.

- **Eager and compiled, every N from 2 to 1,024 and N = 10^6**, at min
  work 0.1, 0.3 and 0.5: the port's values equal the reference's bit
  for bit, and so do the step caps over every total up to 4,096 at the
  N a run meets (8, 30, 353, 772, 1,024, a slice of 10^6).  The
  compiled grid, a compilation per value, has a file for each min work
  (tests/test_torch_work_fraction_compiled_*.py) so that test workers
  share the time.
- **The residual range, pinned**: where XLA splits the fusion into
  parallel tasks (eager N >= 4,443; compiled N >= 131,072) the model is
  exact at the sampled N below except three, whose mismatching value
  counts may not grow.
- **Against the reference's scanned driver itself**: at N=8, min work
  0.3, client 1's work is 0.4 eagerly and 0.40000004 compiled, so at
  E=5 (8 batches) it takes 16 steps on the python driver and 17 on the
  scanned one.  With it in every injected selection, each port driver
  matches the reference's driver of the same kind at 1e-5, and the
  scanned driver's work equals what the reference's chunk realizes.
"""
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs.base import FederatedConfig as JConfig
from repro.core import FederatedTrainer as JTrainer
from repro.core import engine as jengine
from repro.core import scenarios as jscn
from repro.data import make_synthetic as j_make_synthetic
from repro.models.param import init_params as j_init_params
from repro.models.small import logreg_loss as j_logreg_loss
from repro.models.small import logreg_specs as j_logreg_specs
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer
from repro_torch.core import engine as t_engine
from repro_torch.core import scenarios as tscn
from repro_torch.core import pytree as pt
from repro_torch.data import make_synthetic
from repro_torch.models.param import params_from_numpy, params_to_numpy
from repro_torch.models.small import logreg_loss

STARTS = (0.1, 0.3, 0.5)
GRID = list(range(2, 1025)) + [1_000_000]
TOTALS = np.arange(1, 4097, dtype=np.float32)
#: (N, min work) -> how many eager values the model misses, where XLA
#: splits the eager fusion into parallel tasks (ROADMAP Queue 3, F4)
EAGER_MISSES = {(5000, 0.1): 1188, (5000, 0.3): 1147, (5000, 0.5): 1447,
                (999_999, 0.1): 1, (999_999, 0.3): 1,
                (1_000_002, 0.3): 2}
SPLIT_N = [4443, 5000, 6665, 8888, 10_000, 17_777, 65_537, 100_000,
           131_072, 196_608, 500_001, 999_999, 1_000_001, 1_000_002,
           1_048_576]


def _reference(start, n, compiled):
    fn = jscn.scenario_spec("partial_work").work_fraction
    cfg = JConfig(partial_min_work=start)
    if compiled:
        return np.asarray(jax.jit(lambda: fn(cfg, n))())
    return np.asarray(fn(cfg, n))


def _port(start, n, compiled):
    return tscn.staged_work(tscn.scenario_spec("partial_work"),
                            FederatedConfig(partial_min_work=start), n,
                            compiled=compiled).numpy()


def _caps(work):
    return np.minimum(TOTALS, np.ceil(work[:, None] * TOTALS))


def check_grid(start, compiled):
    """Every N from 2 to 1,024 and N = 10^6: the work fractions bitwise,
    and the step caps at every total up to 4,096 where a run meets the
    N."""
    for n in GRID:
        want, got = _reference(start, n, compiled), _port(start, n, compiled)
        assert np.array_equal(want.view(np.int32), got.view(np.int32)), n
        if n in (8, 30, 353, 772, 1024, 1_000_000):
            cut = slice(n - 1024, n) if n > 1024 else slice(None)
            assert np.array_equal(_caps(want[cut]), _caps(got[cut])), n


@pytest.mark.parametrize("start", STARTS)
def test_eager_work_fraction_matches_reference_bitwise(start):
    """The eager form (the python and buffered drivers); the compiled
    form's grid is in tests/test_torch_work_fraction_compiled_*.py."""
    check_grid(start, compiled=False)


@pytest.mark.parametrize("start", STARTS)
def test_split_range_stays_pinned(start):
    """Where XLA splits the fusion into parallel tasks: the compiled
    form is exact at every sampled N, and the eager form misses no more
    values than :data:`EAGER_MISSES` records (zero elsewhere)."""
    for n in SPLIT_N:
        for compiled in (False, True):
            miss = int((_reference(start, n, compiled).view(np.int32)
                        != _port(start, n, compiled).view(np.int32)).sum())
            allowed = 0 if compiled else EAGER_MISSES.get((n, start), 0)
            assert miss <= allowed, (n, compiled, miss)


# -- against the reference's drivers ----------------------------------------

N, K, E = 8, 4, 5
KW = dict(num_devices=N, devices_per_round=K, local_epochs=E,
          learning_rate=0.05, mu=0.01, seed=7, scenario="partial_work",
          partial_min_work=0.3, algorithm="fedavg", engine="batched")
#: client 1 in every round's cohort
SEL = np.array([[1, 0, 5, 6], [2, 1, 7, 3], [4, 6, 1, 0]])


@pytest.fixture(scope="module")
def data():
    jds = j_make_synthetic(0.5, 0.5, num_devices=N, seed=2)
    tds = make_synthetic(0.5, 0.5, num_devices=N, seed=2, device="cpu")
    p0 = jax.tree_util.tree_map(
        np.asarray, j_init_params(j_logreg_specs(60, 10),
                                  jax.random.PRNGKey(0)))
    return jds, tds, p0


def test_client_one_cap_moves(data):
    """The case the driver tests below stand on: client 1 has 8 batches,
    and at E=5 its cap is 16 steps eagerly and 17 compiled."""
    _, tds, _ = data
    assert tds.device_batches(1)["x"].shape[0] == 8
    eager, comp = _port(0.3, N, False)[1], _port(0.3, N, True)[1]
    total = np.float32(E * 8)
    assert (np.ceil(eager * total), np.ceil(comp * total)) == (16.0, 17.0)


def _record_chunk_work(monkeypatch) -> Dict[int, np.ndarray]:
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


@pytest.mark.parametrize("driver", ["scan", "python"])
def test_driver_matches_reference_with_moving_cap(data, monkeypatch,
                                                  driver):
    """Each port driver against the reference's driver of the same kind,
    3 rounds with client 1 selected throughout (params at 1e-5); on the
    scanned driver the realized work equals the reference chunk's bit
    for bit, and is the compiled form."""
    jds, tds, p0 = data
    chunk = _record_chunk_work(monkeypatch)
    works = []
    realize = t_engine.realize_env_staged

    def spy(*a):
        env = realize(*a)
        works.append(env.work.clone())
        return env

    monkeypatch.setattr(t_engine, "realize_env_staged", spy)
    jtr = JTrainer(j_logreg_loss, jds, JConfig(**KW, round_driver=driver))
    _, jp = jtr.run(jax.tree_util.tree_map(jnp.asarray, p0), 3,
                    selections=SEL)
    ttr = FederatedTrainer(logreg_loss, tds,
                           FederatedConfig(**KW, round_driver=driver),
                           device="cpu")
    _, tp = ttr.run(params_from_numpy(p0, device="cpu"), 3, selections=SEL)
    for a, b in zip(pt.leaves(params_to_numpy(tp)),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    if driver == "scan":
        comp = _port(0.3, N, True)
        assert len(works) == 3 and sorted(chunk) == [0, 1, 2]
        for r in range(3):
            assert np.array_equal(works[r].numpy().view(np.int32),
                                  chunk[r].view(np.int32))
            assert np.array_equal(works[r].numpy(), comp[SEL[r]])
    else:
        assert not chunk and not works


def test_moving_cap_changes_the_result(data):
    """The cap matters: the port's scanned driver given the eager form
    moves away from the reference's scanned run by more than 1e-5."""
    jds, tds, p0 = data
    jtr = JTrainer(j_logreg_loss, jds, JConfig(**KW, round_driver="scan"))
    _, jp = jtr.run(jax.tree_util.tree_map(jnp.asarray, p0), 3,
                    selections=SEL)
    ttr = FederatedTrainer(logreg_loss, tds,
                           FederatedConfig(**KW, round_driver="scan"),
                           device="cpu")
    ttr.run(params_from_numpy(p0, device="cpu"), 1, selections=SEL)
    drv = ttr._scanned
    drv._frac = torch.from_numpy(_port(0.3, N, False))
    _, tp = drv.run(params_from_numpy(p0, device="cpu"), 3, selections=SEL)
    err = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(
        pt.leaves(params_to_numpy(tp)), jax.tree_util.tree_leaves(jp)))
    assert err > 1e-5
