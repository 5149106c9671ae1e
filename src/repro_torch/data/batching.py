"""Federated dataset container: fixed-shape padded batch stacks per device.

Counterpart of ``repro/data/batching.py``.  Each device's arrays are
padded to a whole number of batches by *cycling* its own examples, then
reshaped to ``(num_batches, batch_size, ...)`` with ``num_batches``
bucketed to the next power of two -- the same numpy indexing as the
reference, so the arrays are bit-identical.  The stacks move to the
dataset's device once, when the dataset is built; rounds only index and
stack tensors that already live there.

``stack_device_batches`` builds the batched round engine's input: the K
selected devices' stacks padded (by cycling whole batches) to the
selection's largest bucket and stacked along a leading device axis,
with a float32 ``(K, nb_max)`` validity mask; ``stack_eval_batches``
the scanned driver's on-device global loss: every eval device's batches
stacked the same way, with the weights p_k.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import pytree as pt
from repro_torch.device import resolve_device


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def pad_to_batches(arrays: Dict[str, np.ndarray], batch_size: int,
                   bucket: bool = True,
                   device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    n = next(iter(arrays.values())).shape[0]
    nb = batch_count(n, batch_size, bucket)
    target = nb * batch_size
    idx = np.arange(target) % n           # cycle the device's own examples
    out = {}
    for k, a in arrays.items():
        padded = np.ascontiguousarray(
            a[idx].reshape((nb, batch_size) + a.shape[1:]))
        out[k] = torch.from_numpy(padded).to(dev)
    return out


def num_batches_of(batches) -> int:
    """Leading (num_batches) dim of one device's padded batch stack."""
    return pt.leaves(batches)[0].shape[0]


def batch_count(n: int, batch_size: int, bucket: bool = True) -> int:
    """The batch count :func:`pad_to_batches` gives ``n`` examples: a
    rank of the client mesh pads its rows of a cohort to the count of
    the whole cohort, told from the clients' sizes alone."""
    nb = max(1, math.ceil(n / batch_size))
    return _next_pow2(nb) if bucket else nb


def pad_batch_stack(batches, nb: int):
    """Pad a ``(num_batches, batch, ...)`` stack to ``nb`` batches by
    cycling whole batches (each padded batch is a real batch of the same
    device, so gradients stay finite; the engine masks them out)."""
    cur = num_batches_of(batches)
    if nb < cur:
        raise ValueError(
            f"pad_batch_stack: target nb={nb} < current {cur} batches "
            "would silently drop device data")
    if cur == nb:
        return batches
    idx = torch.arange(nb) % cur
    return pt.tmap(lambda x: x[idx.to(x.device)], batches)


def stack_device_batches(dataset, indices, nb: Optional[int] = None
                         ) -> Tuple[dict, torch.Tensor]:
    """Stack the selected devices' batch stacks along a leading axis.

    Returns ``(stacked, valid)``: leaves ``(K, nb_max, batch, ...)`` and
    a float32 ``(K, nb_max)`` mask, 1 for a device's own (bucketed)
    batches and 0 for those that only reach the common ``nb_max``.
    Masked batches are no-ops in the engine (zero gradient weight,
    identity SGD step), which keeps parity with the looped path.
    ``nb_max`` is the selection's largest stack, or ``nb`` when given
    (a rank of the client mesh pads its rows to the whole cohort's).
    """
    getter = getattr(dataset, "device_batches_padded", None)
    devs = [dataset.device_batches(int(k)) for k in indices]
    nbs = [num_batches_of(d) for d in devs]
    nb_max = max(nbs) if nb is None else nb
    if nb_max < max(nbs):
        raise ValueError(f"stack_device_batches: nb={nb} < the selection's "
                         f"{max(nbs)} batches would silently drop data")
    if getter is not None:
        padded = [getter(int(k), nb_max) for k in indices]
    else:
        padded = [pad_batch_stack(d, nb_max) for d in devs]
    stacked = pt.stack(padded)
    valid = torch.from_numpy(
        (np.arange(nb_max)[None, :] < np.asarray(nbs)[:, None])
        .astype(np.float32))
    return stacked, valid.to(pt.leaves(stacked)[0].device)


def stack_eval_batches(dataset) -> Tuple[dict, torch.Tensor, torch.Tensor]:
    """Stack every eval device's batches for the scanned driver's
    on-device global loss.

    Consumes the ``dataset.eval_batches()`` protocol that
    ``FederatedTrainer.global_loss`` iterates (so per-device eval limits
    and samples hold alike) and returns ``(stacked, valid, weights)``:
    leaves ``(N, nb_max, batch, ...)``, a float32 ``(N, nb_max)``
    validity mask and the float32 ``(N,)`` weights p_k, on the stacks'
    device.  Padded slots cycle a device's own batches and are masked
    out, so each device's mean loss over its valid batches is the host
    eval's.
    """
    weights, stacks = [], []
    for wk, batches in dataset.eval_batches():
        weights.append(float(wk))
        stacks.append(batches)
    nbs = [num_batches_of(b) for b in stacks]
    nb_max = max(nbs)
    stacked = pt.stack([pad_batch_stack(b, nb_max) for b in stacks])
    dev = pt.leaves(stacked)[0].device
    valid = torch.from_numpy(
        (np.arange(nb_max)[None, :] < np.asarray(nbs)[:, None])
        .astype(np.float32)).to(dev)
    return stacked, valid, torch.tensor(weights, dtype=torch.float32,
                                        device=dev)


class FederatedData:
    """The dataset protocol consumed by ``FederatedTrainer``.

    ``device``: where the padded batch stacks live -- the card unless
    ``device="cpu"``.  They are moved there once, here.
    """

    def __init__(self, device_data: List[Dict[str, np.ndarray]],
                 batch_size: int, bucket: bool = True,
                 eval_batch_limit: Optional[int] = None, name: str = "",
                 eval_sample: Optional[int] = None, eval_seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.name = name
        self.batch_size = batch_size
        self.num_devices = len(device_data)
        self.sizes = [next(iter(d.values())).shape[0] for d in device_data]
        total = sum(self.sizes)
        self.weights = [s / total for s in self.sizes]   # p_k = n_k / n
        self._batches = [pad_to_batches(d, batch_size, bucket, self.device)
                         for d in device_data]
        self._eval_limit = eval_batch_limit
        self._eval_sample = eval_sample
        self._eval_seed = eval_seed
        self._eval_ids: Optional[np.ndarray] = None
        self._pad_cache: Dict[int, dict] = {}

    def device_batches(self, k: int):
        return self._batches[k]

    def num_batches(self, k: int) -> int:
        """Device ``k``'s batch count."""
        return num_batches_of(self._batches[k])

    def device_batches_padded(self, k: int, nb: int):
        """``device_batches(k)`` cycled out to ``nb >= num_batches``.

        Only the largest padding seen so far is cached per device:
        cycling makes any shorter padding an exact prefix of a longer
        one, so smaller requests slice the cached stack.
        """
        own = num_batches_of(self._batches[k])
        if nb < own:
            raise ValueError(
                f"device_batches_padded: nb={nb} < device {k}'s "
                f"{own} batches would silently drop data")
        cached = self._pad_cache.get(k)
        if cached is None or num_batches_of(cached) < nb:
            cached = pad_batch_stack(self._batches[k], nb)
            self._pad_cache[k] = cached
        if num_batches_of(cached) == nb:
            return cached
        return pt.tmap(lambda x: x[:nb], cached)

    def eval_ids(self) -> np.ndarray:
        """The devices ``eval_batches`` iterates: all of them, or -- with
        ``eval_sample`` below ``num_devices`` -- a fixed seeded uniform
        sample without replacement, in id order (the reference's
        stream, so the same devices)."""
        if self._eval_ids is None:
            if (self._eval_sample is None
                    or self._eval_sample >= self.num_devices):
                self._eval_ids = np.arange(self.num_devices)
            else:
                rng = np.random.default_rng([self._eval_seed, 0xE7A1])
                self._eval_ids = np.sort(rng.choice(
                    self.num_devices, size=self._eval_sample,
                    replace=False))
        return self._eval_ids

    def eval_batches(self) -> Iterable[Tuple[float, dict]]:
        for k in self.eval_ids():
            b = self._batches[k]
            if self._eval_limit is not None:
                b = {key: v[: self._eval_limit] for key, v in b.items()}
            yield self.weights[k], b

    def stats(self) -> Dict[str, float]:
        s = np.array(self.sizes)
        return {"devices": self.num_devices, "samples": int(s.sum()),
                "mean": float(s.mean()), "stdev": float(s.std())}
