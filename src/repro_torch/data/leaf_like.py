"""Procedural stand-ins for the LEAF datasets of the paper (§V-A).

A verbatim numpy copy of ``repro/data/leaf_like.py``, so the arrays come
out bit-identical to the reference's.  Lognormal per-device sizes match
Table I; every device draws from its own distribution:

- femnist_like: 784-dim images, 10 classes; per-device class skew
  (Dirichlet) plus a writer-style affine transform.  Convex model
  (logistic regression).
- sent140_like: binary sentiment over token sequences; two class-
  conditional Markov chains plus a per-device class prior and vocabulary
  bias.  Non-convex model (``models.small.sentlstm_*``).
- shakespeare_like: next-char prediction; per-device (role) bigram chain
  = a shared chain mixed with a role-specific perturbation.  Non-convex
  model (``models.small.charlstm_*``).

``make_*`` build a :class:`FederatedData` on ``device`` -- the card
unless ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.data.batching import FederatedData

FEMNIST_CLASSES = 10
FEMNIST_DIM = 784
SENT_VOCAB = 400
SENT_SEQ = 25
SHAKES_VOCAB = 80
SHAKES_SEQ = 80


def _sizes(rng, num_devices, mean, stdev, min_samples=8, cap=5000):
    """Lognormal sizes matched to a target mean/stdev (Table I)."""
    sigma2 = np.log(1 + (stdev / mean) ** 2)
    mu = np.log(mean) - sigma2 / 2
    s = rng.lognormal(mu, np.sqrt(sigma2), num_devices).astype(int)
    return np.clip(s, min_samples, cap)


# ---------------------------------------------------------------------------
# FEMNIST-like
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Sent140-like
# ---------------------------------------------------------------------------

def generate_sent140_like(num_devices: int = 772, seed: int = 0,
                          mean_samples: int = 53, stdev_samples: int = 32
                          ) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    sizes = _sizes(rng, num_devices, mean_samples, stdev_samples, cap=300)
    # class-conditional token transition logits
    trans = rng.normal(0, 1, (2, SENT_VOCAB, SENT_VOCAB)) * 0.8
    devices = []
    for k in range(num_devices):
        n = int(sizes[k])
        prior = rng.beta(2, 2)                      # device class prior
        vocab_bias = rng.normal(0, 0.8, SENT_VOCAB)  # user vocabulary
        y = (rng.random(n) < prior).astype(np.int32)
        toks = np.zeros((n, SENT_SEQ), np.int32)
        probs_cache = {}
        for c in (0, 1):
            logits = trans[c] + vocab_bias[None, :]
            z = logits - logits.max(axis=1, keepdims=True)
            e = np.exp(z)
            probs_cache[c] = e / e.sum(axis=1, keepdims=True)
        cur = rng.integers(0, SENT_VOCAB, n)
        toks[:, 0] = cur
        for t in range(1, SENT_SEQ):
            for c in (0, 1):
                mask = y == c
                if mask.any():
                    P = probs_cache[c][cur[mask]]
                    cum = P.cumsum(axis=1)
                    r = rng.random((mask.sum(), 1))
                    cur[mask] = (cum < r).sum(axis=1)
            toks[:, t] = cur
        devices.append({"tokens": toks, "y": y})
    return devices


def make_sent140_like(num_devices: int = 772, seed: int = 0,
                      batch_size: int = 10, device=None,
                      **kw) -> FederatedData:
    return FederatedData(
        generate_sent140_like(num_devices, seed, **kw),
        batch_size=batch_size, name="sent140_like", device=device)


# ---------------------------------------------------------------------------
# Shakespeare-like
# ---------------------------------------------------------------------------

def generate_shakespeare_like(num_devices: int = 143, seed: int = 0,
                              mean_samples: int = 3616,
                              stdev_samples: int = 6808,
                              sample_cap: int = 512
                              ) -> List[Dict[str, np.ndarray]]:
    """sample_cap bounds per-device samples for CPU tractability (the full
    LEAF Shakespeare averages 3616 lines/device; pass cap=10_000 for the
    faithful size)."""
    rng = np.random.default_rng(seed)
    sizes = _sizes(rng, num_devices, mean_samples, stdev_samples,
                   min_samples=32, cap=sample_cap)
    # shared "language": sparse bigram chain over the char vocab
    shared = rng.normal(0, 1, (SHAKES_VOCAB, SHAKES_VOCAB))
    devices = []
    for k in range(num_devices):
        n = int(sizes[k])
        role = rng.normal(0, 0.7, (SHAKES_VOCAB, SHAKES_VOCAB))
        logits = shared + role
        z = logits - logits.max(axis=1, keepdims=True)
        e = np.exp(z)
        P = e / e.sum(axis=1, keepdims=True)
        cum = P.cumsum(axis=1)
        seq = np.zeros((n, SHAKES_SEQ + 1), np.int32)
        cur = rng.integers(0, SHAKES_VOCAB, n)
        seq[:, 0] = cur
        for t in range(1, SHAKES_SEQ + 1):
            r = rng.random((n, 1))
            cur = (cum[cur] < r).sum(axis=1)
            seq[:, t] = cur
        devices.append({"tokens": seq[:, :-1], "labels": seq[:, 1:]})
    return devices


def make_shakespeare_like(num_devices: int = 143, seed: int = 0,
                          batch_size: int = 10, device=None,
                          **kw) -> FederatedData:
    return FederatedData(
        generate_shakespeare_like(num_devices, seed, **kw),
        batch_size=batch_size, name="shakespeare_like", device=device)
