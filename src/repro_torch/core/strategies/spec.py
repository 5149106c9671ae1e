"""Declarative algorithm specs + registry (the pluggable strategy API).

Counterpart of ``repro/core/strategies/spec.py``.  Every federated
algorithm is ONE registered :class:`AlgorithmSpec`: the round's phase
structure, the per-device correction rule, which proximal coefficient
applies, the persistent state, and what the server does after
aggregation.  ``FederatedTrainer``'s host loop and ``RoundEngine``'s
batched round are generic interpreters of the spec.

The rules (``correction``, ``control_update``) are written once with
``repro_torch.core.pytree`` ops over either per-device trees (host loop)
or K-stacked trees (batched round); broadcasting makes one definition
serve both, and per-device scalars go through :func:`bscale`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import pytree as pt


class CorrCtx(NamedTuple):
    """Inputs available to a spec's ``correction`` rule (unused fields
    are ``None``).  Global state (``w0``, ``g_global``, ``c_server``,
    ``center``) stays unstacked and broadcasts against the K axis."""
    w0: Any            # round-start global params w^{t-1}
    g_global: Any      # aggregated gradient g_t (fresh or stale) or None
    g_local: Any       # this device's full gradient at w0, or None
    c_server: Any      # SCAFFOLD server control c, or None
    c_local: Any       # SCAFFOLD device control c_k, or None
    center: Any        # S-DANE auxiliary prox center v^t, or None
    mu: float          # effective proximal coefficient for this round
    decay: Any         # spec.decay(cfg, t) if declared, else 1.0


class ControlCtx(NamedTuple):
    """Inputs to a spec's post-solve ``control_update`` rule."""
    c_local: Any       # device control entering the round
    c_server: Any      # round-start server control
    w0: Any            # round-start global params
    w_new: Any         # the device's local solution
    inv_steps: Any     # 1 / (local_steps * learning_rate); scalar or (K,)


def bscale(tree, s):
    """Scale ``tree`` by ``s``: a host scalar (host loop) or a
    per-device ``(K,)`` tensor (stacked paths), broadcast over trailing
    axes."""
    if not isinstance(s, torch.Tensor):
        return pt.scale(tree, s)
    return pt.tmap(
        lambda x: x * s.reshape(s.shape + (1,) * (x.ndim - s.ndim)), tree)


#: Persistent-state fields a spec may declare (``opt`` is appended by
#: :func:`runtime_state_fields` when the server optimizer is non-trivial).
STATE_FIELDS = ("g_prev", "controls", "center")

GRAD_SOURCES = ("none", "fresh", "stale")

SERVER_OPTS = ("sgd", "momentum", "adam")


@dataclass(frozen=True)
class AlgorithmSpec:
    """One federated algorithm, declaratively (field meanings as in the
    reference's ``AlgorithmSpec``)."""
    name: str
    summary: str
    comm_per_round: int
    num_selections: int
    grad_source: str = "none"
    local_grad: bool = False
    updates_g_prev: bool = False
    correction: Optional[Callable[[CorrCtx], Any]] = None
    use_mu: bool = True
    decay: Optional[Callable[[Any, Any], Any]] = None
    state_fields: Tuple[str, ...] = ()
    control_update: Optional[Callable[[ControlCtx], Any]] = None
    server_opt: Optional[str] = None
    center_update: Optional[Callable[[Any, Any, Any], Any]] = None


_REGISTRY: Dict[str, AlgorithmSpec] = {}


def _check_spec(spec: AlgorithmSpec) -> None:
    """Completeness check, raised at registration, not first use."""
    def bad(msg):
        raise ValueError(f"AlgorithmSpec {spec.name!r}: {msg}")

    if not spec.name or not spec.name.isidentifier():
        bad(f"name must be a non-empty identifier, got {spec.name!r}")
    if spec.comm_per_round < 1:
        bad(f"comm_per_round must be >= 1, got {spec.comm_per_round}")
    if spec.num_selections not in (0, 1, 2):
        bad(f"num_selections must be 0, 1 or 2, got {spec.num_selections}")
    if spec.grad_source not in GRAD_SOURCES:
        bad(f"grad_source must be one of {GRAD_SOURCES}, "
            f"got {spec.grad_source!r}")
    unknown = set(spec.state_fields) - set(STATE_FIELDS)
    if unknown:
        bad(f"unknown state_fields {sorted(unknown)}; "
            f"valid: {STATE_FIELDS}")
    if spec.grad_source == "stale" and (
            "g_prev" not in spec.state_fields or not spec.updates_g_prev):
        bad("grad_source='stale' requires 'g_prev' in state_fields and "
            "updates_g_prev=True")
    if spec.updates_g_prev and not spec.local_grad:
        bad("updates_g_prev=True requires local_grad=True")
    if spec.updates_g_prev and "g_prev" not in spec.state_fields:
        bad("updates_g_prev=True requires 'g_prev' in state_fields")
    if "g_prev" in spec.state_fields and not spec.updates_g_prev:
        bad("'g_prev' state without updates_g_prev=True never changes")
    if spec.grad_source == "fresh" and spec.num_selections == 1:
        bad("grad_source='fresh' with one selection is ambiguous; use "
            "num_selections=2 or 0")
    if spec.control_update is not None and \
            "controls" not in spec.state_fields:
        bad("control_update requires 'controls' in state_fields")
    if "controls" in spec.state_fields and spec.control_update is None:
        bad("'controls' state without a control_update rule never "
            "changes")
    if spec.center_update is not None and \
            "center" not in spec.state_fields:
        bad("center_update requires 'center' in state_fields")
    if "center" in spec.state_fields and spec.center_update is None:
        bad("'center' state without a center_update rule never changes")
    if spec.server_opt is not None and spec.server_opt not in SERVER_OPTS:
        bad(f"server_opt must be one of {SERVER_OPTS}, "
            f"got {spec.server_opt!r}")
    if spec.local_grad and spec.grad_source == "none":
        bad("local_grad=True with grad_source='none' computes per-device "
            "gradients nothing consumes")


def register_algorithm(spec: AlgorithmSpec, *,
                       override: bool = False) -> AlgorithmSpec:
    """Register ``spec`` under ``spec.name``; duplicates need
    ``override=True``."""
    _check_spec(spec)
    if spec.name in _REGISTRY and not override:
        raise ValueError(
            f"algorithm {spec.name!r} is already registered; pass "
            f"override=True to replace it")
    _REGISTRY[spec.name] = spec
    return spec


def unregister_algorithm(name: str) -> None:
    """Remove ``name`` from the registry (test cleanup)."""
    _REGISTRY.pop(name, None)


def available_algorithms() -> Tuple[str, ...]:
    """Sorted names of every registered algorithm."""
    return tuple(sorted(_REGISTRY))


def algorithm_spec(name: str) -> AlgorithmSpec:
    """Look up a registered spec; unknown names raise with the list."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; registered: "
            f"{', '.join(available_algorithms())}") from None


def validate_server_opt(name: str) -> None:
    """Raise ``ValueError`` unless ``name`` is in :data:`SERVER_OPTS`."""
    if name not in SERVER_OPTS:
        raise ValueError(
            f"unknown server_opt {name!r}; choose from "
            f"{', '.join(SERVER_OPTS)}")


def make_server_opt(spec: AlgorithmSpec, cfg):
    """The server-side optimizer for (spec, cfg); ``None`` for plain SGD
    at ``server_lr == 1.0`` (Alg. 1/2's unmodified averaging)."""
    name = spec.server_opt or cfg.server_opt
    validate_server_opt(name)
    if name == "sgd" and float(cfg.server_lr) == 1.0:
        return None
    from repro_torch.optim import optimizers
    if name == "sgd":
        return optimizers.sgd(cfg.server_lr)
    if name == "momentum":
        return optimizers.momentum(cfg.server_lr, cfg.server_momentum)
    return optimizers.adam(cfg.server_lr)


def runtime_state_fields(spec: AlgorithmSpec, cfg) -> Tuple[str, ...]:
    """The spec's declared state fields plus ``"opt"`` when the resolved
    server optimizer is non-trivial."""
    fields = list(spec.state_fields)
    if make_server_opt(spec, cfg) is not None:
        fields.append("opt")
    return tuple(fields)


def init_aux(spec: AlgorithmSpec, cfg, params,
             num_devices: int) -> Dict[str, Any]:
    """Initial persistent state for (spec, cfg) in the host-loop layout:
    per-device controls in a
    :class:`~repro_torch.core.client_state.SparseClientState`; ``center``
    starts as a copy of ``params``."""
    aux: Dict[str, Any] = {}
    for f in runtime_state_fields(spec, cfg):
        if f == "g_prev":
            aux["g_prev"] = pt.zeros_like(params)
        elif f == "center":
            aux["center"] = pt.tmap(torch.clone, params)
        elif f == "controls":
            from repro_torch.core.client_state import SparseClientState
            aux["c_server"] = pt.zeros_like(params)
            aux["controls"] = SparseClientState(num_devices,
                                                pt.zeros_like(params))
        elif f == "opt":
            aux["opt"] = make_server_opt(spec, cfg).init(params)
    return aux
