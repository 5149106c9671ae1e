"""Server side: device sampling and aggregation (Alg. 1/2 lines 3, 6-7, 9).

Counterpart of ``repro/core/server.py``: sampling, the synchronous
aggregates and, for the buffered driver, the staleness weights and the
weighted mean of a commit buffer.  There are two samplers:

- :func:`sample_devices` (host) draws from the python and buffered
  drivers' ``np.random.default_rng(seed)`` stream with the same numpy call as
  the reference, so a seed gives exactly the reference's selections;
- :func:`sample_devices_onchip` (device) draws from a ``torch.Generator``
  on the scanned driver's device, inside its captured round.

As in the reference, the two draw from the same distribution (per-device
marginals p_k; without replacement the Gumbel-top-k construction is
numpy's sequential renormalized draw) through different bit streams, so
the drivers' selections are not the same for a seed; each driver is
reproducible for a fixed seed (tests/test_torch_sampling.py,
tests/test_torch_scan.py).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import pytree as pt
from repro_torch.core import sharding


def sample_devices(rng: np.random.Generator, num_devices: int, k: int,
                   p: Optional[Sequence[float]] = None,
                   replace: bool = False) -> np.ndarray:
    """Select |S_t| = K devices; each chosen with probability p_k (paper
    line 3).  Without replacement, p is renormalized as numpy does."""
    k = min(k, num_devices) if not replace else k
    probs = None
    if p is not None:
        probs = np.asarray(p, dtype=np.float64)
        probs = probs / probs.sum()
    return rng.choice(num_devices, size=k, replace=replace, p=probs)


def sample_devices_onchip(gen: torch.Generator, num_devices: int, k: int,
                          p=None, replace: bool = False) -> torch.Tensor:
    """:func:`sample_devices` on the generator's device: an int64 ``(k,)``
    index tensor there, with no host sync and no op a CUDA graph cannot
    capture (``gen`` must then be registered with the graph).

    Without replacement: the Gumbel-top-k of ``log p`` (uniform: of the
    Gumbel noise alone).  With replacement: the inverse CDF of ``k``
    uniforms over the cumulative sum of ``p`` (uniform: ``randint``).
    ``num_devices``, ``k``, ``replace`` and the presence of ``p`` are
    fixed per call site.
    """
    dev = gen.device
    if not replace:
        k = min(k, num_devices)
    if p is not None:
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        # Population-scale guard: raw client weights can overflow (a sum
        # of huge weights -> inf) or vanish (denormal sizes) before the
        # normalizing division.  Pre-scale by the max ONLY in those
        # regimes, so that in-range weights keep their exact bits
        # (x / 1.0 is an identity in IEEE 754).
        m = p.max()
        p = p / torch.where((m > 1e30) | (m < 1e-30), m,
                            torch.ones_like(m))
        p = p / p.sum()
    if replace:
        if p is None:
            return torch.randint(num_devices, (k,), generator=gen,
                                 device=dev)
        cdf = torch.cumsum(p, 0)
        u = torch.rand(k, generator=gen, device=dev) * cdf[-1]
        return torch.searchsorted(cdf, u, right=True).clamp_(
            max=num_devices - 1)
    u = torch.rand(num_devices, generator=gen, device=dev)
    scores = -torch.log(-torch.log(torch.clamp(
        u, min=torch.finfo(torch.float32).tiny)))
    if p is not None:
        scores = scores + torch.log(torch.clamp(p, min=1e-30))
    return torch.topk(scores, k).indices


def aggregate_mean(updates: List) -> object:
    """w^t = (1/K) sum_k w_k^t  (unweighted mean over the selected set,
    Alg. 1 line 7 / Alg. 2 line 9)."""
    return pt.mean(updates)


def aggregate_weighted(updates: List, weights: Sequence[float]) -> object:
    """n_k-weighted aggregation (FedAvg as McMahan et al. implement it)."""
    return pt.weighted_mean(updates, list(weights))


def aggregate_gradients(grads: List) -> object:
    """g_t = (1/K) sum_{k in S_t} grad F_k(w^{t-1})  (Alg. 2 line 6)."""
    return pt.mean(grads)


def aggregate_stacked(tree, mesh=None) -> object:
    """Mean over the leading device axis of a K-stacked tree -- the
    batched round's form of ``aggregate_mean``/``aggregate_gradients``
    (stays on the device).

    ``mesh`` (a :class:`~repro_torch.core.sharding.ClientMesh`): the
    leaves hold this rank's K/D rows; the local mean is then averaged
    over the ranks through the aggregation tree (``tree_pmean``), which
    equals the global mean to float association, every rank holding
    the same row count.  ``None`` is the single-process program.
    """
    out = pt.tmap(lambda x: x.mean(dim=0), tree)
    return sharding.tree_pmean(out, mesh)


def aggregate_stacked_masked(tree, active, fallback, mesh=None) -> object:
    """Mean over the devices with ``active[k] > 0`` of a K-stacked tree
    (``active`` a float 0/1 ``(K,)`` vector): inactive rows contribute
    exact zeros, so the result equals the looped path's plain mean over
    the active subset.  With no active device, ``fallback`` (an
    unstacked tree: ``w0`` for params, the carried value for state) is
    returned instead.

    ``mesh``: as in :func:`aggregate_stacked`; the masked partial sums
    and the active count are summed over the ranks (``tree_psum``)
    before the one division, so the global masked mean and the
    no-active-device decision are exact however the active clients
    fall over the ranks.
    """
    def msum(x):
        return (x * active.reshape(active.shape + (1,) * (x.ndim - 1))
                ).sum(dim=0)

    # the count and every leaf's partial sum in one collective step
    asum, sums = sharding.tree_psum((active.sum(), pt.tmap(msum, tree)),
                                    mesh)
    denom = torch.clamp(asum, min=1.0)
    return pt.tmap(lambda s, fb: torch.where(asum > 0, s / denom, fb),
                   sums, fallback)


#: Staleness -> mixing-weight families of the buffered driver
#: (``FederatedConfig.staleness_fn``); the map is :func:`staleness_weight`.
STALENESS_FNS = ("constant", "polynomial")


def staleness_weight(name: str, staleness) -> torch.Tensor:
    """Mixing weight of a buffered update whose anchor is ``staleness``
    commits old (FedBuff, Nguyen et al. 2022), as a float32 tensor of
    ``staleness``'s shape: ``"constant"`` gives ones (the synchronous
    mean), ``"polynomial"`` FedBuff's ``(1 + s) ** -0.5``."""
    s = torch.as_tensor(staleness, dtype=torch.float32)
    if name == "constant":
        return torch.ones_like(s)
    if name == "polynomial":
        return (1.0 + s) ** -0.5
    raise ValueError(
        f"unknown staleness_fn {name!r}; choose from "
        f"{', '.join(STALENESS_FNS)}")


def aggregate_buffered(deltas, weights: torch.Tensor, mesh=None):
    """Staleness-weighted mean of a full commit buffer: ``deltas`` has a
    leading buffer axis M (row i a client's pseudo-gradient
    ``anchor_i - w_i``), ``weights`` the float ``(M,)`` vector of
    :func:`staleness_weight`.  Divides by ``max(sum(weights), 1e-12)``;
    with constant weights this is :func:`aggregate_stacked`'s mean.

    ``mesh``: M is a multiple of the rank count (padded rows weigh 0);
    each rank reduces its M/D rows, and the weighted numerator and the
    weight sum are summed over the ranks (``tree_psum``) before the one
    division, so padded rows drop out of both sums."""
    if mesh is not None:
        lo, hi = sharding.shard_rows(weights.shape[0], mesh)
        w = weights[lo:hi]
        wsum, nums = sharding.tree_psum((w.sum(), pt.tmap(
            lambda x: (x[lo:hi] * w.reshape(w.shape + (1,) * (x.ndim - 1))
                       ).sum(dim=0), deltas)), mesh)
        wsum = torch.clamp(wsum, min=1e-12)
        return pt.tmap(lambda x: x / wsum, nums)
    wsum = torch.clamp(weights.sum(), min=1e-12)

    def wmean(x):
        w = weights.reshape(weights.shape + (1,) * (x.ndim - 1))
        return (x * w).sum(dim=0) / wsum

    return pt.tmap(wmean, deltas)


def server_step(w0, w_agg, opt=None, opt_state=None):
    """Post-aggregation server update: hands the pseudo-gradient
    ``w0 - w_agg`` to an optimizer and applies the result to ``w0``.
    ``opt=None`` is plain averaging (``w_agg`` returned untouched).
    Returns ``(new_params, new_opt_state)``."""
    if opt is None:
        return w_agg, opt_state
    updates, new_state = opt.update(pt.sub(w0, w_agg), opt_state, w0)
    return pt.add(w0, updates), new_state
