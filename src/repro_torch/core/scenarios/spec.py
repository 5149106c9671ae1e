"""Declarative federated-environment scenarios + registry.

Counterpart of ``repro/core/scenarios/spec.py`` for the synchronous
python driver.  A :class:`ScenarioSpec` models the environment -- per-
device availability, straggler latency against a server deadline,
dropout mid-round, partial work -- and the trainer's two engines
(``batched`` and ``loop``) interpret it.

Round semantics (as the reference): availability gates both the
phase-A gradient gather and the solve; stragglers, dropout and partial
work act on the solve only.  For the K selected solve devices a round
realizes

- ``active``: float 0/1, the device's update reaches the server;
- ``work``: float in (0, 1], the fraction of its local steps it runs
  (``min(total, ceil(work * total))`` of its ``E * num_batches``).

Randomness: spec callables never draw.  They map uniform draws (and the
round index) to probabilities and latencies.  The trainer draws one
``(N,)`` float64 uniform per channel of :func:`env_channels`, in that
order, from its numpy ``default_rng(cfg.seed)`` stream -- the same
calls as the reference -- and rounds them to float32, so a seed realizes
the reference's environment.  The interpreter runs in float32 in the
reference's order of operations (``f32math`` for ``exp``/``ndtri``),
because ``u < p`` and ``lat <= deadline`` are threshold tests that one
ulp can flip.

The scanned driver realizes the environment inside its captured round
on the card: :func:`staged_availability` and :func:`staged_work` run on
the host (the round index enters only there), and
:func:`realize_env_staged` / :func:`availability_mask_staged` turn the
staged values and the round's uniforms into the same masks on any
device.

The buffered driver reads a scenario as an event queue
(:func:`realize_event_env`): the latency draw is the client's arrival
delay rather than a test against the deadline, availability and
dropout mean the update is never delivered, and the work assignment
still truncates the solve.  It runs on the CPU, from the same host
uniforms and with the same float32 functions as :func:`realize_env`.

The ``"ideal"`` scenario is structurally trivial (:func:`is_trivial`):
every path keeps its exact pre-scenario code, with no draws and no
masks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

#: Straggler deadline policies: ``"drop"`` discards late devices;
#: ``"partial"`` accepts the iterate a late device reached at the
#: deadline (work fraction deadline/latency).
DEADLINE_POLICIES = ("drop", "partial")

F32 = torch.float32


@dataclass(frozen=True)
class ScenarioSpec:
    """One federated environment, declaratively.

    - ``availability(cfg, num_devices, t) -> (N,)``: per-device
      probability of being reachable at round ``t``; ``None`` = always.
    - ``latency_quantile(cfg, u) -> latencies``: inverse CDF of the
      per-device round latency applied to uniforms ``u``; ``None`` = no
      stragglers.  ``deadline_policy`` says what happens to devices
      later than ``cfg.straggler_deadline``.
    - ``dropout``: each device drops mid-round w.p. ``cfg.dropout_rate``.
    - ``work_fraction(cfg, num_devices) -> (N,)``: deterministic
      per-device fraction of local work; ``None`` = full work.  It may
      carry a ``compiled`` attribute of the same signature: the values
      inside the reference's compiled chunk (:func:`staged_work`).

    Callables return float32 tensors (or values ``torch.as_tensor``
    turns into them) on the CPU.
    """
    name: str
    summary: str
    availability: Optional[Callable[[Any, int, Any], Any]] = None
    latency_quantile: Optional[Callable[[Any, Any], Any]] = None
    deadline_policy: str = "drop"
    dropout: bool = False
    work_fraction: Optional[Callable[[Any, int], Any]] = None


class RoundEnv(NamedTuple):
    """One round's realized environment for the K selected devices."""
    active: Any   # float (K,) 0/1 -- update reaches the server
    work: Any     # float (K,) in (0, 1] -- fraction of local steps done


#: Uniform channels a round may consume, in the fixed order both the
#: reference and the port draw them.  Each is one (N,) draw per round,
#: indexed by device id, so duplicate selections share one outcome.
ENV_CHANNELS = ("avail", "latency", "dropout")


def is_trivial(spec: ScenarioSpec) -> bool:
    """True when the scenario is the identity environment."""
    return (spec.availability is None and spec.latency_quantile is None
            and not spec.dropout and spec.work_fraction is None)


def env_channels(spec: ScenarioSpec) -> Tuple[str, ...]:
    """The uniform channels this spec consumes, in draw order."""
    out = []
    if spec.availability is not None:
        out.append("avail")
    if spec.latency_quantile is not None:
        out.append("latency")
    if spec.dropout:
        out.append("dropout")
    return tuple(out)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def realize_env(spec: ScenarioSpec, cfg, num_devices: int, sel, t,
                uniforms: Dict[str, Any]) -> RoundEnv:
    """The scenario interpreter: uniforms -> (active, work) for ``sel``.

    ``sel`` is the (K,) solve selection (int tensor), ``t`` the round
    index and ``uniforms`` maps each channel of :func:`env_channels` to
    an (N,) float32 draw, per device.
    """
    return realize_env_staged(spec, cfg, sel,
                              staged_availability(spec, cfg, num_devices, t),
                              staged_work(spec, cfg, num_devices), uniforms)


class EventEnv(NamedTuple):
    """One cohort launch's realized environment under the event-queue
    (buffered driver) reading of a scenario (:func:`realize_event_env`)."""
    delivered: Any  # float (K,) 0/1 -- the finished update reaches the server
    work: Any       # float (K,) in (0, 1] -- fraction of local steps done
    latency: Any    # float (K,) > 0 -- completion delay, in nominal rounds


def realize_event_env(spec: ScenarioSpec, cfg, num_devices: int, sel, t,
                      uniforms: Dict[str, Any]) -> EventEnv:
    """The event-queue scenario interpreter of the buffered driver.

    The inputs of :func:`realize_env`, read without a round barrier: the
    latency process is not compared with ``cfg.straggler_deadline`` but
    IS the client's arrival delay (clamped at 1e-6); a straggler lands
    later, so staler, and ``cfg.max_staleness`` takes the deadline's
    place at the server.  Availability and dropout clear ``delivered``;
    the work assignment truncates the solve.  A spec without a latency
    process completes in exactly 1.0 nominal round, which keeps cohorts
    aligned (the degenerate-parity configuration).
    """
    sel = torch.as_tensor(sel, dtype=torch.long)
    k = sel.shape[0]
    delivered = torch.ones(k, dtype=F32)
    work = torch.ones(k, dtype=F32)
    latency = torch.ones(k, dtype=F32)
    if spec.availability is not None:
        p = staged_availability(spec, cfg, num_devices, t)
        delivered = delivered * (uniforms["avail"][sel] < p[sel])
    if spec.latency_quantile is not None:
        latency = torch.clamp(
            _f32(spec.latency_quantile(cfg, uniforms["latency"][sel])),
            min=1e-6)
    if spec.dropout:
        delivered = delivered * (uniforms["dropout"][sel]
                                 >= cfg.dropout_rate)
    if spec.work_fraction is not None:
        work = work * staged_work(spec, cfg, num_devices)[sel]
    return EventEnv(delivered=delivered.to(F32),
                    work=torch.clamp(work, 1e-6, 1.0), latency=latency)


def availability_mask(spec: ScenarioSpec, cfg, num_devices: int, sel, t,
                      uniforms: Dict[str, Any]) -> torch.Tensor:
    """The availability-only 0/1 mask for ``sel`` -- what gates the
    phase-A gradient gather.  Uses the same per-device ``"avail"``
    draw as :func:`realize_env`; all ones without an availability
    process."""
    return availability_mask_staged(
        spec, sel, staged_availability(spec, cfg, num_devices, t), uniforms)


def staged_availability(spec: ScenarioSpec, cfg, num_devices: int,
                        t) -> Optional[torch.Tensor]:
    """The (N,) float32 availability probabilities of round ``t`` on the
    CPU (``None`` without an availability process): what the scanned
    driver computes on the host for each round of a chunk and stages on
    its device."""
    if spec.availability is None:
        return None
    return _f32(spec.availability(cfg, num_devices, t))


def staged_work(spec: ScenarioSpec, cfg, num_devices: int,
                compiled: bool = False) -> Optional[torch.Tensor]:
    """The (N,) float32 work fractions on the CPU (``None`` without a
    work assignment); they do not depend on the round.  ``compiled``:
    the values the reference computes inside its compiled scan chunk,
    where the callable has a ``compiled`` form (the built-in linspace
    does: XLA evaluates it differently eagerly and compiled)."""
    if spec.work_fraction is None:
        return None
    fn = spec.work_fraction
    if compiled:
        fn = getattr(fn, "compiled", fn)
    return _f32(fn(cfg, num_devices))


def realize_env_staged(spec: ScenarioSpec, cfg, sel, p, frac,
                       uniforms: Dict[str, Any]) -> RoundEnv:
    """:func:`realize_env` from the round's staged availability ``p`` and
    the work fractions ``frac`` (:func:`staged_availability`,
    :func:`staged_work`), on the device of ``sel``, ``p``, ``frac`` and
    ``uniforms``: no host sync, so the scanned driver's captured round
    runs it on the card.  Every operation is exact or correctly rounded
    in float32 (``f32math``), so the card realizes the CPU's masks bit
    for bit."""
    sel = torch.as_tensor(sel, dtype=torch.long)
    k = sel.shape[0]
    active = torch.ones(k, dtype=F32, device=sel.device)
    work = torch.ones(k, dtype=F32, device=sel.device)
    if spec.availability is not None:
        active = active * (uniforms["avail"][sel] < p[sel])
    if spec.latency_quantile is not None:
        lat = _f32(spec.latency_quantile(cfg, uniforms["latency"][sel]))
        if spec.deadline_policy == "drop":
            active = active * (lat <= cfg.straggler_deadline)
        else:
            # a tensor numerator: PyTorch takes ``scalar / tensor`` as
            # a reciprocal times the scalar, which rounds twice
            work = work * torch.clamp(
                torch.full_like(lat, cfg.straggler_deadline)
                / torch.clamp(lat, min=1e-9), 0.0, 1.0)
    if spec.dropout:
        active = active * (uniforms["dropout"][sel] >= cfg.dropout_rate)
    if spec.work_fraction is not None:
        work = work * frac[sel]
    return RoundEnv(active=active.to(F32),
                    work=torch.clamp(work, 1e-6, 1.0))


def availability_mask_staged(spec: ScenarioSpec, sel, p,
                             uniforms: Dict[str, Any]) -> torch.Tensor:
    """:func:`availability_mask` from the round's staged ``p``, on the
    device of ``sel`` (see :func:`realize_env_staged`)."""
    sel = torch.as_tensor(sel, dtype=torch.long)
    if spec.availability is None:
        return torch.ones(sel.shape[0], dtype=F32, device=sel.device)
    return (uniforms["avail"][sel] < p[sel]).to(F32)


_REGISTRY: Dict[str, ScenarioSpec] = {}


def _check_scenario(spec: ScenarioSpec) -> None:
    """Completeness check at registration."""
    def bad(msg):
        raise ValueError(f"ScenarioSpec {spec.name!r}: {msg}")

    if not spec.name or not spec.name.isidentifier():
        bad(f"name must be a non-empty identifier, got {spec.name!r}")
    if spec.deadline_policy not in DEADLINE_POLICIES:
        bad(f"deadline_policy must be one of {DEADLINE_POLICIES}, "
            f"got {spec.deadline_policy!r}")
    if spec.latency_quantile is None and \
            spec.deadline_policy != DEADLINE_POLICIES[0]:
        bad("deadline_policy is meaningless without latency_quantile; "
            "leave it at the default")


def register_scenario(spec: ScenarioSpec, *,
                      override: bool = False) -> ScenarioSpec:
    """Register ``spec`` under ``spec.name``; duplicates need
    ``override=True``."""
    _check_scenario(spec)
    if spec.name in _REGISTRY and not override:
        raise ValueError(
            f"scenario {spec.name!r} is already registered; pass "
            f"override=True to replace it")
    _REGISTRY[spec.name] = spec
    return spec


def unregister_scenario(name: str) -> None:
    """Remove ``name`` from the registry (test cleanup)."""
    _REGISTRY.pop(name, None)


def available_scenarios() -> Tuple[str, ...]:
    """Sorted names of every registered scenario."""
    return tuple(sorted(_REGISTRY))


def scenario_spec(name: str) -> ScenarioSpec:
    """Look up a registered scenario; unknown names raise with the full
    sorted list."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; registered: "
            f"{', '.join(available_scenarios())}") from None
