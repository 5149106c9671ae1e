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

def _linear_work_fraction(cfg, num_devices):
    """Per-device work fractions spread linearly from
    ``cfg.partial_min_work`` to 1.0 (``jnp.linspace`` in float32).

    Written as ``start * (1 - i*c) + i*(stop*c)`` with ``c = 1/(N-1)``
    and the last product fused into the add.  Measured against the
    reference's eager ``jnp.linspace`` (what its python and buffered
    drivers call): equal bit for bit at N = 12, 30 and 200 with
    ``partial_min_work`` 0.3 and 0.5, and at N = 8 with 0.5; at N = 8
    with 0.3, index 1 is one ulp above it (0.40000004 against 0.4),
    which moves that device's step cap ``ceil(work * steps)`` up by one
    where ``steps`` is a multiple of 5 (tests/test_torch_async.py pins
    it).  The reference's compiled linspace differs from its eager one
    in some values at those N.
    """
    start = torch.tensor(cfg.partial_min_work, dtype=F32)
    if num_devices == 1:
        return start.reshape(1)
    div = num_devices - 1
    c = torch.tensor(1.0, dtype=F32) / div
    i = torch.arange(div, dtype=F32)
    out = f32math.fma(i, c, start * (1.0 - i * c))      # stop = 1.0
    return torch.cat([out, torch.ones(1, dtype=F32)])


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
