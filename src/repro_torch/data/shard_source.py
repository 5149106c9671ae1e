"""Streaming client-shard dataset sources for population-scale runs.

Counterpart of ``repro/data/shard_source.py``.  The pre-stacked
:class:`~repro_torch.data.batching.FederatedData` generates and pads
every client's batches at construction -- O(N) in time and memory,
fine at the paper's N=30..772 and impossible at the N=1,000,000 the
paper's low-participation discussion is about.

A :class:`ClientShardSource` is the streaming side of the same dataset
protocol: ``num_devices``, ``weights``, ``device_batches(k)``,
``device_batches_padded(k, nb)``, ``eval_batches()``.  A client's arrays
are generated only when the client is touched (selected into a cohort,
or in the bounded eval sample), from its own numpy stream
``default_rng([seed, tag, k])``, so client k's shard is the same
whichever cohorts it joins, in whatever order, on whatever host.  An
LRU cache keeps the hot clients' padded batch stacks, as tensors on the
source's ``device`` (the card unless ``device="cpu"``).

The generators make the reference's numpy calls in the reference's
order, so every array is bit-identical to the reference source's.

- ``weights`` is ``None``: exact ``p_k = n_k / n`` needs all N sizes,
  so sampling over a source is uniform.  :meth:`materialize` gives the
  dense container (small N only).
- ``eval_batches()`` iterates a fixed seeded sample of at most
  ``eval_clients`` clients (all of them, in id order, when N is no
  larger), weighted by their sizes; consumers normalise.
- Telemetry: ``materialized_clients`` (generator calls; cache hits do
  not count), ``cache_bytes`` and ``peak_cache_bytes``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from repro_torch.core import pytree as pt
from repro_torch.data.batching import (FederatedData, batch_count,
                                       pad_batch_stack, pad_to_batches)
from repro_torch.device import resolve_device

#: Seed-sequence domain tags: per-client streams, dataset-shared
#: structures and the eval-sample draw never collide.
_TAG_CLIENT = 0x51AD
_TAG_SHARED = 0x5EED
_TAG_EVAL = 0xE7A1


def resolve_streaming(client_source: str, dataset) -> bool:
    """Resolve ``FederatedConfig.client_source`` against a dataset:
    ``"streaming"`` and ``"stacked"`` force the path (streaming needs a
    dataset that declares ``streaming = True``); ``"auto"`` follows the
    dataset."""
    if client_source == "streaming":
        if not getattr(dataset, "streaming", False):
            raise ValueError(
                "client_source='streaming' needs a streaming dataset "
                "(a ClientShardSource); this dataset does not declare "
                "streaming=True")
        return True
    if client_source == "stacked":
        return False
    return bool(getattr(dataset, "streaming", False))


def _tree_bytes(batches) -> int:
    return sum(x.numel() * x.element_size() for x in pt.leaves(batches))


class ClientShardSource:
    """On-demand, seed-per-client federated data.

    Subclasses implement :meth:`_client_arrays`, a pure function of
    ``(self, k)`` returning client k's ``{name: np.ndarray}`` from
    ``self.client_rng(k)``; batching, the cache, the eval sample,
    telemetry and materialization are shared.
    """

    #: the marker ``resolve_streaming`` and the drivers dispatch on
    streaming = True

    def __init__(self, num_devices: int, *, batch_size: int = 10,
                 seed: int = 0, name: str = "shard_source",
                 eval_clients: int = 64, cache_clients: int = 256,
                 device=None):
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got "
                             f"{num_devices}")
        self.device = resolve_device(device)
        self.num_devices = int(num_devices)
        self.batch_size = batch_size
        self.seed = seed
        self.name = name
        #: uniform sampling at population scale
        self.weights = None
        self.eval_clients = min(int(eval_clients), self.num_devices)
        self.cache_clients = max(1, int(cache_clients))
        self._cache: "OrderedDict[int, dict]" = OrderedDict()
        self._sizes: Dict[int, int] = {}    # touched clients only
        self._eval_ids: Optional[np.ndarray] = None
        self.materialized_clients = 0       # generator invocations
        self.cache_bytes = 0
        self.peak_cache_bytes = 0

    # -- per-client determinism -------------------------------------------

    def client_rng(self, k: int) -> np.random.Generator:
        """Client k's own stream: the same across processes, cohort
        orders and cache evictions."""
        return np.random.default_rng([self.seed, _TAG_CLIENT, int(k)])

    def shared_rng(self) -> np.random.Generator:
        """The dataset-level stream for structures every client shares."""
        return np.random.default_rng([self.seed, _TAG_SHARED])

    def _client_arrays(self, k: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _draw_size(self, rng: np.random.Generator) -> int:
        """A client's sample count: the first draw of its stream, which
        :meth:`_client_arrays` makes first too."""
        raise NotImplementedError

    # -- the dataset protocol ---------------------------------------------

    def device_batches(self, k: int):
        """Client k's padded ``(num_batches, batch, ...)`` stack on the
        source's device, generated on first touch and LRU-cached."""
        k = int(k)
        hit = self._cache.get(k)
        if hit is not None:
            self._cache.move_to_end(k)
            return hit
        self.materialized_clients += 1
        arrays = self._client_arrays(k)
        self._sizes[k] = next(iter(arrays.values())).shape[0]
        batches = pad_to_batches(arrays, self.batch_size,
                                 device=self.device)
        self._cache[k] = batches
        self.cache_bytes += _tree_bytes(batches)
        while len(self._cache) > self.cache_clients:
            _, old = self._cache.popitem(last=False)
            self.cache_bytes -= _tree_bytes(old)
        self.peak_cache_bytes = max(self.peak_cache_bytes,
                                    self.cache_bytes)
        return batches

    def device_batches_padded(self, k: int, nb: int):
        """Client k's stack cycled out to ``nb`` batches (not cached:
        cohort paddings are transient and cohort-sized)."""
        return pad_batch_stack(self.device_batches(k), nb)

    def eval_ids(self) -> np.ndarray:
        """The eval sample's client ids: all of them, in order, when
        ``N <= eval_clients``; else a seeded uniform sample without
        replacement, sorted."""
        if self._eval_ids is None:
            if self.eval_clients >= self.num_devices:
                self._eval_ids = np.arange(self.num_devices)
            else:
                rng = np.random.default_rng([self.seed, _TAG_EVAL])
                self._eval_ids = np.sort(rng.choice(
                    self.num_devices, size=self.eval_clients,
                    replace=False))
        return self._eval_ids

    def eval_batches(self) -> Iterable[Tuple[float, dict]]:
        """``(size_k, batches)`` over the eval sample; consumers
        normalise the sizes, so a sample that covers every client gives
        the dense ``p_k`` eval."""
        for k in self.eval_ids():
            b = self.device_batches(int(k))
            yield float(self.size_of(int(k))), b

    def num_batches(self, k: int) -> int:
        """Client k's batch count from its size alone, without generating
        its arrays (no materialization): a rank of the client mesh pads
        its rows of a cohort to the whole cohort's count."""
        k = int(k)
        n = self._sizes.get(k)
        if n is None:
            n = self._sizes[k] = self._draw_size(self.client_rng(k))
        return batch_count(n, self.batch_size)

    def size_of(self, k: int) -> int:
        """Client k's sample count (materializes the client on the first
        ask; touched clients' sizes are kept)."""
        k = int(k)
        if k not in self._sizes:
            self.device_batches(k)
        return self._sizes[k]

    # -- small-N bridges --------------------------------------------------

    def materialize(self) -> FederatedData:
        """The dense container of this source's exact per-client data,
        on the source's device: O(N), small N only."""
        data = [self._client_arrays(k) for k in range(self.num_devices)]
        return FederatedData(data, batch_size=self.batch_size,
                             name=self.name + "_materialized",
                             device=self.device)

    def stats(self) -> Dict[str, float]:
        """Telemetry: the client count and the streaming counters (not
        the O(N) size scan of ``FederatedData.stats``)."""
        return {"devices": self.num_devices,
                "materialized_clients": float(self.materialized_clients),
                "cached_clients": float(len(self._cache)),
                "cache_bytes": float(self.cache_bytes),
                "peak_cache_bytes": float(self.peak_cache_bytes)}


class SyntheticShardSource(ClientShardSource):
    """Streaming synthetic(alpha, beta): the structure of
    ``data.synthetic.generate_synthetic`` (planes ``W_k ~ N(u_k, 1)``,
    feature means ``N(B_k, 1)``, decaying covariance), every client from
    its own ``[seed, tag, k]`` stream."""

    def __init__(self, alpha: float = 0.0, beta: float = 0.0, *,
                 iid: bool = False, num_devices: int = 30,
                 seed: int = 0, min_samples: int = 50,
                 batch_size: int = 10, **kw):
        super().__init__(num_devices, batch_size=batch_size, seed=seed,
                         name=f"synthetic_stream({alpha},{beta})", **kw)
        self.alpha, self.beta, self.iid = alpha, beta, iid
        self.min_samples = min_samples
        from repro_torch.data.synthetic import NUM_CLASSES, NUM_FEATURES
        self._nf, self._nc = NUM_FEATURES, NUM_CLASSES
        self._cov_diag = np.array(
            [(j + 1) ** -1.2 for j in range(self._nf)])
        shared = self.shared_rng()
        self._w_shared = shared.normal(0, 1, (self._nf, self._nc))
        self._b_shared = shared.normal(0, 1, self._nc)

    def _draw_size(self, rng: np.random.Generator) -> int:
        return int(np.clip(rng.lognormal(4.0, 2.0) + self.min_samples,
                           self.min_samples, 1000))

    def _client_arrays(self, k: int) -> Dict[str, np.ndarray]:
        from repro_torch.data.synthetic import _softmax
        rng = self.client_rng(k)
        n = self._draw_size(rng)
        u = rng.normal(0, self.alpha)
        if self.iid:
            W, b = self._w_shared, self._b_shared
        else:
            W = rng.normal(u, 1, (self._nf, self._nc))
            b = rng.normal(u, 1, self._nc)
        Bk = rng.normal(0, self.beta)
        mean_x = rng.normal(Bk, 1, self._nf)
        x = rng.normal(mean_x, np.sqrt(self._cov_diag),
                       (n, self._nf))
        logits = x @ W + b
        probs = _softmax(logits)
        y = np.array([rng.choice(self._nc, p=p) for p in probs])
        return {"x": x.astype(np.float32), "y": y.astype(np.int32)}


class FemnistShardSource(ClientShardSource):
    """Streaming femnist_like: shared smooth class templates, a
    per-client Dirichlet class skew and writer-style affine transform
    (``data.leaf_like.generate_femnist_like``'s structure), every client
    from its own stream."""

    def __init__(self, num_devices: int = 200, *, seed: int = 0,
                 class_concentration: float = 0.5,
                 mean_samples: int = 92, stdev_samples: int = 159,
                 batch_size: int = 10, **kw):
        super().__init__(num_devices, batch_size=batch_size, seed=seed,
                         name="femnist_stream", **kw)
        from repro_torch.data.leaf_like import FEMNIST_CLASSES, FEMNIST_DIM
        self._nc, self._dim = FEMNIST_CLASSES, FEMNIST_DIM
        self.class_concentration = class_concentration
        sigma2 = np.log(1 + (stdev_samples / mean_samples) ** 2)
        self._size_mu = np.log(mean_samples) - sigma2 / 2
        self._size_sigma = np.sqrt(sigma2)
        shared = self.shared_rng()
        base = shared.normal(0, 1, (self._nc, 28, 28))
        from numpy.fft import fft2, ifft2
        freq = np.exp(-0.15 * (np.add.outer(np.arange(28) ** 2,
                                            np.arange(28) ** 2) ** 0.5))
        templates = np.stack([np.real(ifft2(fft2(b) * freq))
                              for b in base])
        self._templates = templates / templates.std() * 2.0

    def _draw_size(self, rng: np.random.Generator) -> int:
        return int(np.clip(rng.lognormal(self._size_mu, self._size_sigma),
                           8, 5000))

    def _client_arrays(self, k: int) -> Dict[str, np.ndarray]:
        rng = self.client_rng(k)
        n = self._draw_size(rng)
        class_probs = rng.dirichlet(
            np.full(self._nc, self.class_concentration))
        y = rng.choice(self._nc, size=n, p=class_probs)
        gain = rng.normal(1.0, 0.25)
        bias = rng.normal(0.0, 0.3)
        style = rng.normal(0, 0.4, (28, 28))
        x = (self._templates[y] * gain + bias + style
             + rng.normal(0, 0.6, (n, 28, 28)))
        return {"x": x.reshape(n, self._dim).astype(np.float32),
                "y": y.astype(np.int32)}


def make_synthetic_stream(alpha: float = 0.0, beta: float = 0.0,
                          **kw) -> SyntheticShardSource:
    """The streaming counterpart of ``data.synthetic.make_synthetic``
    (same (alpha, beta) axes); ``device=`` as ``FederatedData``."""
    return SyntheticShardSource(alpha, beta, **kw)


def make_femnist_stream(num_devices: int = 200,
                        **kw) -> FemnistShardSource:
    """The streaming counterpart of ``data.leaf_like.make_femnist_like``;
    ``device=`` as ``FederatedData``."""
    return FemnistShardSource(num_devices, **kw)
