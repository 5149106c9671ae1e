"""Instrumentation for the paper's analysis (§IV).

Counterpart of ``repro/core/theory.py``:

- B-local dissimilarity (Definition 2) measured on live training state
  (``FederatedTrainer.measure_dissimilarity``); the norms are read back
  to the host and combined in numpy float64, as the reference does;
- γ-inexactness (Definition 1) via ``client.gamma_inexactness``;
- the sufficient-decrease constants ρ from Theorems 3, 5 and 7, so tests
  and benchmarks can check when the theory predicts decrease.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import pytree as pt


def b_dissimilarity(local_grads: List, p: Optional[Sequence[float]] = None
                    ) -> float:
    """B(w) = sqrt( E_k ||grad F_k(w)||^2 / ||grad f(w)||^2 ).

    ``local_grads``: per-device gradients at the same w;
    ``p``: device weights p_k (default uniform).  B >= 1 always; == 1 iff
    all device gradients coincide (IID direction test in tests/).
    """
    n = len(local_grads)
    w = np.full(n, 1.0 / n) if p is None else np.asarray(p) / np.sum(p)
    sq = np.array([float(pt.norm_sq(g)) for g in local_grads])
    mean_sq = float(np.sum(w * sq))
    gbar = pt.weighted_mean(local_grads, list(w))
    denom = float(pt.norm_sq(gbar))
    if denom <= 1e-24:
        return float("inf")
    return float(np.sqrt(mean_sq / denom))


def rho_convex(mu: float, gamma: float, L: float, B: float) -> float:
    """Theorem 3 sufficient-decrease constant (convex case)."""
    return ((2 - 3 * gamma) / (2 * mu)
            - (2 * L * (1 + gamma) ** 2 + 3 * L) / (2 * mu ** 2)
            - (B ** 2 - 1) * ((L * (1 + gamma) ** 2 + L) / mu ** 2
                              + gamma / mu))


def rho_nonconvex(mu: float, gamma: float, L: float, B: float,
                  lam: float) -> float:
    """Theorem 5 sufficient-decrease constant (non-convex case);
    requires mu - lam > 0."""
    d = mu - lam
    assert d > 0, "need mu > lambda"
    return (1 / mu - 3 * gamma / (2 * d)
            - L * (1 + gamma) ** 2 / d ** 2
            - 3 * L / (2 * mu * d)
            - (B ** 2 - 1) * (L * (1 + gamma) ** 2 / d ** 2
                              + L / (mu * d) + gamma / d))


def rho_device_specific(mus: Sequence[float], gammas: Sequence[float],
                        Ls: Sequence[float], B: float) -> float:
    """Theorem 7 sufficient-decrease constant (device-specific constants)."""
    mus, gammas, Ls = map(np.asarray, (mus, gammas, Ls))
    t1 = np.mean(1 / mus - 3 * gammas / (2 * mus)
                 - Ls * (1 + gammas) ** 2 / mus ** 2
                 - 3 * Ls / (2 * mus ** 2))
    t2 = np.mean(Ls * (1 + gammas) ** 2 / mus ** 2
                 + Ls / mus ** 2 + gammas / mus) * (B ** 2 - 1)
    return float(t1 - t2)


def corollary4_mu(L: float, B: float) -> float:
    """Corollary 4: with gamma=0 and B >> 1, mu ~= 5 L B^2 gives
    rho ~= 3 / (25 L B^2)."""
    return 5.0 * L * B * B
