"""Li et al. synthetic(alpha, beta) federated datasets (paper §V-A).

A verbatim numpy copy of ``repro/data/synthetic.py``'s generator, so the
arrays come out bit-identical to the reference's.  For each of N=30
devices:
  u_k ~ N(0, alpha);   W_k ~ N(u_k, 1) in R^{60x10},  b_k ~ N(u_k, 1)
  B_k ~ N(0, beta);    v_k ~ N(B_k, 1) in R^60
  x   ~ N(v_k, Sigma), Sigma = diag(j^{-1.2})
  y   = argmax softmax(W_k^T x + b_k)
The IID variant shares (W, b) and draws x ~ N(0, Sigma) on all devices.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.data.batching import FederatedData

NUM_FEATURES = 60
NUM_CLASSES = 10


def _softmax(z):
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def generate_synthetic(alpha: float, beta: float, *, iid: bool = False,
                       num_devices: int = 30, seed: int = 0,
                       min_samples: int = 50) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    sizes = (rng.lognormal(4.0, 2.0, num_devices).astype(int)
             + min_samples)
    sizes = np.clip(sizes, min_samples, 1000)

    cov_diag = np.array([(j + 1) ** -1.2 for j in range(NUM_FEATURES)])
    W_shared = rng.normal(0, 1, (NUM_FEATURES, NUM_CLASSES))
    b_shared = rng.normal(0, 1, NUM_CLASSES)

    devices = []
    for k in range(num_devices):
        if iid:
            W, b = W_shared, b_shared
            mean_x = np.zeros(NUM_FEATURES)
        else:
            u = rng.normal(0, np.sqrt(alpha))
            W = rng.normal(u, 1, (NUM_FEATURES, NUM_CLASSES))
            b = rng.normal(u, 1, NUM_CLASSES)
            Bk = rng.normal(0, np.sqrt(beta))
            mean_x = rng.normal(Bk, 1, NUM_FEATURES)
        n = int(sizes[k])
        x = rng.normal(mean_x, np.sqrt(cov_diag), (n, NUM_FEATURES))
        probs = _softmax(x @ W + b)
        y = np.array([rng.choice(NUM_CLASSES, p=p) for p in probs])
        devices.append({"x": x.astype(np.float32),
                        "y": y.astype(np.int32)})
    return devices


def make_synthetic(alpha: float, beta: float, *, iid: bool = False,
                   num_devices: int = 30, seed: int = 0,
                   batch_size: int = 10, device=None) -> FederatedData:
    name = "synthetic_iid" if iid else f"synthetic({alpha},{beta})"
    return FederatedData(
        generate_synthetic(alpha, beta, iid=iid, num_devices=num_devices,
                           seed=seed),
        batch_size=batch_size, name=name, device=device)


# The paper's four synthetic datasets (Fig. 1 top row)
def paper_synthetic_suite(seed: int = 0, batch_size: int = 10,
                          device=None) -> List[FederatedData]:
    return [
        make_synthetic(0, 0, iid=True, seed=seed, batch_size=batch_size,
                       device=device),
        make_synthetic(0, 0, seed=seed, batch_size=batch_size,
                       device=device),
        make_synthetic(0.5, 0.5, seed=seed, batch_size=batch_size,
                       device=device),
        make_synthetic(1, 1, seed=seed, batch_size=batch_size,
                       device=device),
    ]
