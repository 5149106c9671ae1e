"""Rank body for tests/test_torch_lm_train.py: the pod-as-client round
on the client mesh.

``podfed_round`` runs on every rank of a ``core.sharding.run_on_mesh``
group (gloo on the CPU).  Each rank takes its own ``pods / D`` pods of
the parent's numpy state and batch, runs one
``launch.podfed.make_podfed_round_step`` round with the rank's
:class:`~repro_torch.core.sharding.ClientMesh`, and returns its new
state and loss as numpy.

Imports torch and repro_torch only: the ranks never load JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import pytree as pt
from repro_torch.launch.podfed import make_podfed_round_step
from repro_torch.models.param import params_from_numpy, params_to_numpy


def podfed_round(mesh, arch, reduce_kw, state, batch, kw):
    torch.set_num_threads(1)
    cfg = get_arch(arch).reduced(**reduce_kw)
    per = pt.leaves(state["params"])[0].shape[0] // mesh.world
    lo = mesh.rank * per

    def mine(tree):
        return pt.tmap(lambda x: x[lo:lo + per], tree)

    fn, info = make_podfed_round_step(cfg, mesh, **kw)
    new, out = fn(params_from_numpy(mine(state), device="cpu"),
                  {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in mine(batch).items()})
    return {"rank": mesh.rank, "state": params_to_numpy(new),
            "loss": float(out["loss"]), "info": info}
