"""Client-to-server wire accounting.

Counterpart of the byte telemetry of ``repro/core/codecs/spec.py``
(``round_bytes``) for the one codec the port runs so far, ``"none"``:
every update and gradient crosses the wire as dense float32.  The lossy
codecs and their fused aggregate kernels are a later slice.
"""
from typing import Tuple

#: Bytes per element of a dense float32 payload.
DENSE_BYTES = 4.0

#: Codecs the port runs; ``FederatedConfig`` rejects the others.
CODECS = ("none",)


def round_bytes(algo_spec, n_elems: int, n_gather: float,
                n_up: float) -> Tuple[float, float]:
    """Wire bytes ``(up, down)`` for one round of ``algo_spec`` under
    the dense codec, by the reference's model: ``n_elems`` real
    parameters, ``n_gather`` phase-A gradient devices, ``n_up`` solve
    devices.  Downlink ships ``w0`` to each separately selected phase-A
    device and ``w0`` plus (for corrected algorithms) one model-width
    correction to each solve device; uplink ships the phase-A gradients
    and each update (pipelined FedDANE adds its fresh gradient)."""
    dense = DENSE_BYTES * n_elems
    gather_down = n_gather if algo_spec.num_selections == 2 else 0.0
    corr_down = 1.0 if algo_spec.correction is not None else 0.0
    grad_up = 1.0 if algo_spec.updates_g_prev else 0.0
    down = dense * gather_down + dense * (1.0 + corr_down) * n_up
    up = dense * n_gather + (dense + dense * grad_up) * n_up
    return up, down
