"""Rank body for tests/test_torch_mesh_drivers.py and the card's mesh
test in tests/test_torch_cuda.py: the scanned and buffered drivers, and
streaming sources, on the port's client mesh.

``run_cases`` runs on every rank of a ``core.sharding.run_on_mesh``
group.  Each case builds the rank's own trainer with the rank's
:class:`~repro_torch.core.sharding.ClientMesh` (or none, for the
parent's single-process runs of the same cases) and runs it from the
parent's numpy params, and returns numpy results: final params, the
history, every draw of the host and card samplers in order, each
round's realized solve mask and phase-A availability (scanned driver),
the source's materialized clients and the driver ``run`` took.  A case
may carry tables the parent made from the reference: codec draws of
every round's K slots (each rank takes its own through
``codecs.round_draws``' ``idx0``, or the scanned driver its rows of
them) and the environment's uniforms of every round, indexed by the
round tensor ``t`` in place of ``engine.scan_env_uniforms``.

Imports torch and repro_torch only: the ranks never load JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer
from repro_torch.core import codecs, engine, server
from repro_torch.core.engine import ScannedDriver
from repro_torch.data import make_synthetic, make_synthetic_stream
from repro_torch.models.param import params_from_numpy, params_to_numpy
from repro_torch.models.small import logreg_loss

#: The streaming source's bounded eval sample.
EVAL_CLIENTS = 8


def dataset(data, device):
    """``("dense", N)``: synthetic(1,1) of N devices; ``("stream", N)``:
    its streaming counterpart."""
    kind, n = data
    if kind == "stream":
        return make_synthetic_stream(1, 1, num_devices=n, seed=0,
                                     eval_clients=EVAL_CLIENTS,
                                     device=device)
    return make_synthetic(1, 1, num_devices=n, seed=0, device=device)


def _table_draws(table):
    def draws(spec, cfg, t, k, rows, device="cpu", idx0=0):
        if not spec.uses_rng:
            return None
        signs, u, noise = table[t]
        return codecs.CodecDraws(*(torch.from_numpy(a).to(device) for a in
                                   (signs, u[idx0:idx0 + k], noise)))
    return draws


class _Spies:
    """Module attributes the drivers look up at call time, replaced for
    one case: the samplers and the scanned driver's environment (both
    recorded, with ``record``; eager rounds only), the codec draws and
    the environment's uniforms (from the parent's tables)."""

    def __init__(self, draws, env, record=True):
        self.sel, self.active, self.avail = [], [], []
        self._saved = []
        tables = (None if env is None else
                  {c: torch.from_numpy(v) for c, v in env.items()})

        def spy_on(fn, out, pick=lambda r: r):
            def spy(*a, **k):
                r = fn(*a, **k)
                out.append(pick(r).detach().cpu().numpy().copy()
                           if torch.is_tensor(pick(r))
                           else np.asarray(pick(r)).copy())
                return r
            return spy

        def uniforms(gen, channels, n, t):
            return {c: tables[c].index_select(0, t.cpu())[0].to(gen.device)
                    for c in channels}

        if record:
            self._set(server, "sample_devices",
                      spy_on(server.sample_devices, self.sel))
            self._set(server, "sample_devices_onchip",
                      spy_on(server.sample_devices_onchip, self.sel))
            self._set(engine, "realize_env_staged",
                      spy_on(engine.realize_env_staged, self.active,
                             lambda r: r.active))
            self._set(engine, "availability_mask_staged",
                      spy_on(engine.availability_mask_staged, self.avail))
        if draws is not None:
            self._set(codecs, "round_draws", _table_draws(draws))
        if tables is not None:
            self._set(engine, "scan_env_uniforms", uniforms)

    def _set(self, mod, name, value):
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def restore(self):
        for mod, name, value in reversed(self._saved):
            setattr(mod, name, value)


def run_case(mesh, case, p0, device="cpu"):
    """One case (module docstring) on this rank, or in one process with
    ``mesh=None``."""
    ds = dataset(case["data"], mesh.device if mesh is not None else device)
    kw = dict(case["kw"])
    if mesh is not None:
        kw.update(mesh_devices=mesh.world, edge_shards=mesh.edge_shards)
    tr = FederatedTrainer(logreg_loss, ds, FederatedConfig(**kw),
                          device=None if mesh is not None else device,
                          mesh=mesh)
    spies = _Spies(case.get("draws"), case.get("env"))
    try:
        hist, final = tr.run(params_from_numpy(p0, device=tr.device),
                             case["rounds"], selections=case.get("sel"))
    finally:
        spies.restore()
    return {"params": params_to_numpy(final), "hist": hist,
            "sel": spies.sel, "active": spies.active, "avail": spies.avail,
            "materialized": getattr(ds, "materialized_clients", None),
            "driver": tr._resolve_driver()}


def run_cases(mesh, cases, p0):
    """Every case of ``cases`` (name -> case) on this rank; returns
    ``{"rank": ..., "cases": {name: result}}``."""
    return {"rank": mesh.rank,
            "cases": {name: run_case(mesh, case, p0)
                      for name, case in cases.items()}}


def segmented_vs_eager(mesh, cases, p0):
    """On the card: each case's scanned run replayed from its captured
    segments, then the same rounds run eagerly on the card (every round
    and eval called directly); returns both results and each program's
    segment and collective counts."""
    out = {}
    for name, case in cases.items():
        ds = dataset(case["data"], mesh.device)
        cfg = FederatedConfig(**dict(case["kw"], mesh_devices=mesh.world,
                                     edge_shards=mesh.edge_shards))
        runs = []
        for eager in (False, True):
            tr = FederatedTrainer(logreg_loss, ds, cfg, mesh=mesh)
            drv = tr._scanned = ScannedDriver(logreg_loss, ds, cfg,
                                              engine=tr.engine)
            if eager:
                drv._step = lambda name, fn: fn()
            # (nothing recorded: a capture reads nothing back)
            spies = _Spies(case.get("draws"), None, record=False)
            try:
                hist, final = tr.run(params_from_numpy(p0, device=tr.device),
                                     case["rounds"],
                                     selections=case.get("sel"))
            finally:
                spies.restore()
            torch.cuda.synchronize()
            runs.append({"params": params_to_numpy(final), "hist": hist,
                         "programs": {k: (p.graph.segments,
                                          p.graph.collectives)
                                      for k, p in drv._programs.items()}})
        out[name] = runs
    return out
