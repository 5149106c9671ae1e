"""The built-in environment scenarios, one :func:`register_scenario`
call each -- counterpart of ``repro/core/scenarios/builtin.py``.

The callables map uniforms and the round index to probabilities,
latencies and work fractions in float32, in the reference's order of
operations.  Knobs live on ``FederatedConfig`` (``avail_prob``,
``diurnal_period``, ``straggler_sigma``, ``straggler_deadline``,
``dropout_rate``, ``partial_min_work``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.scenarios import f32math
from repro_torch.core.scenarios.spec import ScenarioSpec, register_scenario

F32 = torch.float32


# -- availability processes -------------------------------------------------

def _bernoulli_availability(cfg, num_devices, t):
    """Every device independently reachable w.p. ``cfg.avail_prob``."""
    return torch.full((num_devices,), cfg.avail_prob, dtype=F32)


def _diurnal_availability(cfg, num_devices, t):
    """Periodic availability around ``cfg.avail_prob`` with period
    ``cfg.diurnal_period`` rounds and per-device phase 2*pi*k/N."""
    phase = 2.0 * math.pi * torch.arange(num_devices, dtype=F32) \
        / num_devices
    swing = f32math.sin(2.0 * math.pi * t / cfg.diurnal_period + phase)
    return torch.clamp(cfg.avail_prob + 0.5 * swing, 0.0, 1.0)


# -- straggler latency ------------------------------------------------------

def _lognormal_latency(cfg, u):
    """Lognormal latency (median 1.0), sigma ``cfg.straggler_sigma``, by
    the inverse CDF of the uniforms ``u``."""
    u = torch.clamp(torch.as_tensor(u, dtype=F32), 1e-6, 1.0 - 1e-6)
    return f32math.exp(cfg.straggler_sigma * f32math.ndtri(u))


# -- work assignment --------------------------------------------------------

#: Threads of the host that runs the reference.  XLA:CPU splits a large
#: elementwise fusion into parallel tasks by its host's core count, and
#: that split changes which values of the linspace below come out of
#: constant-folded code; the reference's values at the N where it
#: splits (see :func:`_xla_partitions`) are those of an 8-thread host.
XLA_CPU_THREADS = 8


def _xla_partitions(n: int, compiled: bool) -> int:
    """Parallel tasks XLA:CPU's cost model gives the linspace fusion of
    ``n`` outputs: the eager form (start and stop are parameters) is
    compute-bound, ``45 n + 76`` cost units against 100,000 a task, at
    most one task a thread; the compiled form (constants) is bound by
    its ``4 n`` output bytes against 256 KiB a task, at most
    ``ceil(sqrt(threads))`` tasks."""
    if compiled:
        return min(math.ceil(math.sqrt(XLA_CPU_THREADS)),
                   max(1, 4 * n // 262144))
    return min(XLA_CPU_THREADS, max(1, (45 * n + 76) // 100000))


def _xla_linspace(start: float, n: int, compiled: bool) -> torch.Tensor:
    """``jnp.linspace(start, 1.0, n)`` in float32 as XLA:CPU evaluates
    it, eagerly (``compiled=False``) or constant-folded into a compiled
    program (``compiled=True``).

    XLA rewrites the linspace as ``s (1 - i c) + i (1 c)`` with
    ``c = fl(1/(n-1))``; its LLVM backend then contracts multiplies
    into adds (FMA) wherever a product has one use, and folds whatever
    it knows at compile time.  So each value is one of two formulas:

    - where the code knows ``i`` at compile time (the fully unrolled
      kernel below 353 outputs, the tail of the vector loop in the last
      parallel task when its length differs from the others'), ``1 - i
      c`` is folded, correctly rounded: eager ``fma(i, c, s K)``
      (``fma(s, K, c)`` at ``i = 1`` below 35 outputs, where the kernel
      is scalar and ``1 c`` folds away), compiled the plain
      ``i c + s K``;
    - where ``i`` is a run-time value (the vector loop, 32 values an
      iteration, and the tails of the other parallel tasks): eager
      ``fma(i, c, s fma(-i, c, 1))``; compiled ``fma(s, K, i c)``, whose
      ``i c`` has two uses and so is not fused into ``1 - i c``.

    Read off the compiled programs (``_linspace.lower(...).compile()``
    and its LLVM IR) and checked bit for bit against the reference for
    every n from 2 to 1,024 and n = 10^6 at start 0.1, 0.3 and 0.5
    (tests/test_torch_work_fraction*.py).  Where the parallel split
    applies (:func:`_xla_partitions` > 1) the compiled form is exact at
    the sampled n those tests list and the eager form misses a few
    values at three of them, pinned there (ROADMAP.md, fault F4).
    """
    s = torch.tensor(start, dtype=F32)
    if n == 1:
        return s.reshape(1)
    div = n - 1
    c = torch.tensor(1.0, dtype=F32) / div
    i = torch.arange(div, dtype=F32)
    ic = i * c
    k = 1.0 - ic
    if compiled:
        runtime_v = f32math.fma(s.expand(div), k, ic)
        folded_v = ic + s * k
    else:
        runtime_v = f32math.fma(i, c, s * f32math.fma(-i, c, 1.0))
        folded_v = f32math.fma(i, c, s * k)
        if div > 1 and n <= 34:
            folded_v[1] = f32math.fma(s, k[1], c)
    runtime = torch.zeros(div, dtype=torch.bool)
    if n >= 353:
        tasks = _xla_partitions(n, compiled)
        size = n // tasks
        last = n - (tasks - 1) * size - 1      # the last task's formula values
        own_code = tasks == 1 or last != size
        for p in range(tasks):
            lo = p * size
            m = size if p < tasks - 1 else last
            runtime[lo:lo + 32 * (m // 32)] = True
            if not (own_code and p == tasks - 1):
                runtime[lo:lo + m] = True
    out = torch.where(runtime, runtime_v, folded_v)
    return torch.cat([out, torch.ones(1, dtype=F32)])


def _linear_work_fraction(cfg, num_devices):
    """Per-device work fractions spread linearly from
    ``cfg.partial_min_work`` to 1.0: the reference's ``jnp.linspace``
    as its python and buffered drivers evaluate it, eagerly.  The
    ``compiled`` attribute gives the values its scanned driver's
    compiled chunk computes (:func:`_xla_linspace`)."""
    return _xla_linspace(cfg.partial_min_work, num_devices, compiled=False)


_linear_work_fraction.compiled = lambda cfg, num_devices: _xla_linspace(
    cfg.partial_min_work, num_devices, compiled=True)


# -- the registry -----------------------------------------------------------

IDEAL = register_scenario(ScenarioSpec(
    name="ideal",
    summary="identity environment: every selected device is available, "
            "on time, and completes full local work (the paper's "
            "baseline assumption; structurally a no-op)"))

BERNOULLI = register_scenario(ScenarioSpec(
    name="bernoulli",
    summary="each selected device independently available w.p. "
            "avail_prob (low effective participation, the paper's "
            "degradation axis)",
    availability=_bernoulli_availability))

DIURNAL = register_scenario(ScenarioSpec(
    name="diurnal",
    summary="periodic day/night availability with per-device phase "
            "(timezones): correlated, time-varying participation",
    availability=_diurnal_availability))

STRAGGLERS = register_scenario(ScenarioSpec(
    name="stragglers",
    summary="lognormal device latency; the server drops devices that "
            "miss straggler_deadline (synchronous FL with a timeout)",
    latency_quantile=_lognormal_latency,
    deadline_policy="drop"))

STRAGGLERS_PARTIAL = register_scenario(ScenarioSpec(
    name="stragglers_partial",
    summary="lognormal device latency; late devices submit the iterate "
            "they reached at the deadline (FedProx-style partial work)",
    latency_quantile=_lognormal_latency,
    deadline_policy="partial"))

DROPOUT = register_scenario(ScenarioSpec(
    name="dropout",
    summary="each participating device drops mid-round w.p. "
            "dropout_rate; its update is lost",
    dropout=True))

PARTIAL_WORK = register_scenario(ScenarioSpec(
    name="partial_work",
    summary="deterministic device-dependent local epoch counts: work "
            "fractions linear from partial_min_work to 1 across the "
            "fleet (systems heterogeneity without randomness)",
    work_fraction=_linear_work_fraction))

HOSTILE = register_scenario(ScenarioSpec(
    name="hostile",
    summary="everything at once: Bernoulli availability, partial-credit "
            "stragglers, mid-round dropout, and device-dependent work "
            "(the stress composite the property tests hammer)",
    availability=_bernoulli_availability,
    latency_quantile=_lognormal_latency,
    deadline_policy="partial",
    dropout=True,
    work_fraction=_linear_work_fraction))
