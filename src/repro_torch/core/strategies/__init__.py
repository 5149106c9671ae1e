"""Pluggable algorithm-strategy API: declarative specs + registry."""
from repro_torch.core.strategies.spec import (GRAD_SOURCES, SERVER_OPTS,
                                              STATE_FIELDS, AlgorithmSpec,
                                              ControlCtx, CorrCtx,
                                              algorithm_spec,
                                              available_algorithms, bscale,
                                              init_aux, make_server_opt,
                                              register_algorithm,
                                              runtime_state_fields,
                                              unregister_algorithm,
                                              validate_server_opt)
from repro_torch.core.strategies import builtin  # noqa: F401  (registers)

__all__ = [
    "AlgorithmSpec", "CorrCtx", "ControlCtx",
    "register_algorithm", "unregister_algorithm", "algorithm_spec",
    "available_algorithms", "make_server_opt", "validate_server_opt",
    "runtime_state_fields", "init_aux", "bscale",
    "STATE_FIELDS", "GRAD_SOURCES", "SERVER_OPTS",
]
