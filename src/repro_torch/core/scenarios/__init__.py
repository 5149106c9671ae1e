"""Declarative federated-environment scenarios: specs + registry.

Counterpart of ``repro/core/scenarios``: one :class:`ScenarioSpec` per
environment (``builtin.py``: ideal, bernoulli, diurnal, stragglers,
stragglers_partial, dropout, partial_work, hostile); both engines of
the python driver, the scanned driver and, as an event queue
(:func:`realize_event_env`), the buffered driver interpret them.
Register a spec and every path -- and ``FederatedConfig.scenario``
validation -- picks it up.
"""
from repro_torch.core.scenarios.spec import (DEADLINE_POLICIES, ENV_CHANNELS,
                                             EventEnv, RoundEnv,
                                             ScenarioSpec,
                                             availability_mask,
                                             availability_mask_staged,
                                             available_scenarios,
                                             env_channels, is_trivial,
                                             realize_env, realize_env_staged,
                                             realize_event_env,
                                             register_scenario,
                                             scenario_spec,
                                             staged_availability,
                                             staged_work,
                                             unregister_scenario)
from repro_torch.core.scenarios import builtin  # noqa: F401  (registers)

__all__ = [
    "ScenarioSpec", "RoundEnv", "EventEnv",
    "register_scenario", "unregister_scenario", "scenario_spec",
    "available_scenarios", "realize_env", "realize_event_env",
    "availability_mask",
    "realize_env_staged", "availability_mask_staged",
    "staged_availability", "staged_work",
    "env_channels", "is_trivial", "DEADLINE_POLICIES", "ENV_CHANNELS",
]
