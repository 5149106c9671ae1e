"""Rank body for tests/test_torch_sharding.py: the port's client mesh.

``run_cases`` runs on every rank of a ``core.sharding.run_on_mesh``
group (gloo on the CPU).  Each case builds the rank's own trainer with
the rank's :class:`~repro_torch.core.sharding.ClientMesh`, runs 3
rounds from the parent's numpy params with the parent's injected
selections, and returns numpy results: final params, the loss and
``effective_k`` history, each round's scenario masks, and the dense
per-client state (SCAFFOLD controls, codec error feedback).  A case
with ``draws`` replaces ``codecs.round_draws`` by the parent's
per-round table (the reference's ``jax.random`` draws for all K slots),
of which each rank takes its own slots.  ``errors`` are config kwargs
whose trainer build must raise; the child returns each message.
``driver_on_mesh`` builds a trainer on the scanned or the buffered
driver on the mesh.

Imports torch and repro_torch only: the ranks never load JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer
from repro_torch.core import codecs
from repro_torch.core import pytree as pt
from repro_torch.data import make_synthetic
from repro_torch.models.param import params_from_numpy, params_to_numpy
from repro_torch.models.small import logreg_loss


def _table_draws(table):
    def draws(spec, cfg, t, k, rows, device="cpu", idx0=0):
        if not spec.uses_rng:
            return None
        signs, u, noise = table[t]
        return codecs.CodecDraws(*(torch.from_numpy(a).to(device) for a in
                                   (signs, u[idx0:idx0 + k], noise)))
    return draws


def _dense(store):
    if store is None:
        return None
    rows = [pt.leaves(params_to_numpy(store[k]))
            for k in range(store.num_clients)]
    return [np.stack([r[i] for r in rows]) for i in range(len(rows[0]))]


def _run(mesh, ds, p0, sel, rounds, kw, draws):
    cfg = FederatedConfig(**kw)
    tr = FederatedTrainer(logreg_loss, ds, cfg, mesh=mesh)
    states, masks = [], []
    init, step = tr.init, tr.round

    def keep_state(p):
        states.append(init(p))
        return states[-1]

    def keep_masks(st):
        st = step(st)
        masks.append(tr.last_masks)
        return st

    tr.init, tr.round = keep_state, keep_masks
    saved = codecs.round_draws
    if draws is not None:
        codecs.round_draws = _table_draws(draws)
    try:
        hist, final = tr.run(params_from_numpy(p0, device=tr.device), rounds,
                             selections=sel)
    finally:
        codecs.round_draws = saved
    st = states[0]
    return {"params": params_to_numpy(final), "loss": hist["loss"],
            "effective_k": hist["effective_k"],
            "bytes_up": hist["bytes_up"], "masks": masks,
            "controls": _dense(st.controls), "ef": _dense(st.ef)}


def run_cases(mesh, cases, errors, data_kw, p0, sel, rounds):
    """Every case of ``cases`` (name -> (config kwargs, draws or None))
    on this rank, then every config of ``errors`` (name -> kwargs);
    returns ``{"rank": ..., "cases": {...}, "errors": {...}}``."""
    ds = make_synthetic(1, 1, device=mesh.device, **data_kw)
    out = {"rank": mesh.rank, "cases": {}, "errors": {}}
    for name, (kw, draws) in cases.items():
        out["cases"][name] = _run(mesh, ds, p0, sel, rounds, kw, draws)
    for name, kw in errors.items():
        try:
            FederatedTrainer(logreg_loss, ds, FederatedConfig(**kw),
                             mesh=mesh)
        except ValueError as e:
            out["errors"][name] = str(e)
        else:
            out["errors"][name] = None
    return out


def driver_on_mesh(mesh, driver="scan"):
    """A trainer on ``driver`` (the scanned or the buffered one) on this
    rank's mesh: the driver its ``run`` takes (the scanned driver built
    too) and the driver ``auto`` resolves to here."""
    from repro_torch.core.engine import ScannedDriver
    ds = make_synthetic(1, 1, num_devices=4, seed=0, device=mesh.device)
    kw = dict(num_devices=4, devices_per_round=2, mesh_devices="auto")
    cfg = FederatedConfig(round_driver=driver, **kw)
    tr = FederatedTrainer(logreg_loss, ds, cfg, mesh=mesh)
    if driver == "scan":
        ScannedDriver(logreg_loss, ds, cfg, engine=tr.engine)
    auto = FederatedTrainer(logreg_loss, ds, FederatedConfig(**kw),
                            mesh=mesh)
    return tr._resolve_driver(), auto._resolve_driver()


def fail_on_rank_one(mesh):
    """A rank body whose rank 1 raises while rank 0 waits in a
    collective: the launcher must stop rank 0 and raise."""
    if mesh.rank == 1:
        raise RuntimeError("rank one fails on purpose")
    torch.distributed.all_reduce(torch.ones(1))
    return mesh.rank
