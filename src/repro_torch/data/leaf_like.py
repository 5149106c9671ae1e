"""FEMNIST-like procedural stand-in for the LEAF dataset (paper §V-A).

A verbatim numpy copy of the FEMNIST part of ``repro/data/leaf_like.py``
(the Sent140/Shakespeare generators wait for the LSTM models), so the
arrays come out bit-identical to the reference's: 784-dim images, 10
classes, per-device class skew (Dirichlet) plus a writer-style affine
transform, lognormal sizes matched to Table I.  The paper trains the
convex model (logistic regression) on it.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.data.batching import FederatedData

FEMNIST_CLASSES = 10
FEMNIST_DIM = 784


def _sizes(rng, num_devices, mean, stdev, min_samples=8, cap=5000):
    """Lognormal sizes matched to a target mean/stdev (Table I)."""
    sigma2 = np.log(1 + (stdev / mean) ** 2)
    mu = np.log(mean) - sigma2 / 2
    s = rng.lognormal(mu, np.sqrt(sigma2), num_devices).astype(int)
    return np.clip(s, min_samples, cap)


def generate_femnist_like(num_devices: int = 200, seed: int = 0,
                          class_concentration: float = 0.5,
                          mean_samples: int = 92, stdev_samples: int = 159
                          ) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    sizes = _sizes(rng, num_devices, mean_samples, stdev_samples)
    # class templates: smooth random images
    base = rng.normal(0, 1, (FEMNIST_CLASSES, 28, 28))
    from numpy.fft import fft2, ifft2
    freq = np.exp(-0.15 * (np.add.outer(np.arange(28) ** 2,
                                        np.arange(28) ** 2) ** 0.5))
    templates = np.stack([np.real(ifft2(fft2(b) * freq)) for b in base])
    templates = templates / templates.std() * 2.0

    devices = []
    for k in range(num_devices):
        n = int(sizes[k])
        class_probs = rng.dirichlet(
            np.full(FEMNIST_CLASSES, class_concentration))
        y = rng.choice(FEMNIST_CLASSES, size=n, p=class_probs)
        # writer style: per-device gain, bias, and pixel jitter direction
        gain = rng.normal(1.0, 0.25)
        bias = rng.normal(0.0, 0.3)
        style = rng.normal(0, 0.4, (28, 28))
        x = templates[y] * gain + bias + style + rng.normal(0, 0.6,
                                                            (n, 28, 28))
        devices.append({"x": x.reshape(n, FEMNIST_DIM).astype(np.float32),
                        "y": y.astype(np.int32)})
    return devices


def make_femnist_like(num_devices: int = 200, seed: int = 0,
                      batch_size: int = 10, device=None,
                      **kw) -> FederatedData:
    return FederatedData(
        generate_femnist_like(num_devices, seed, **kw),
        batch_size=batch_size, name="femnist_like", device=device)
