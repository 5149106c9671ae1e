"""Batched round engine: one federated round over K stacked devices.

Counterpart of the synchronous ``RoundEngine`` of ``repro/core/engine.py``
(``round_core`` without scenario, mesh or codec).  The K selected
devices' padded batch stacks are stacked along a leading device axis,
phase-A gradients come from one vmapped gradient pass, and the local
solve runs in lockstep through ``client.make_batched_solver`` -- on the
card through the update or fused local-solve kernels.  Devices whose
stack is shorter take masked identity steps, so each device's
trajectory is the one the looped reference gives it (parity at atol
1e-5).

There is no per-algorithm code here: :class:`RoundEngine` interprets
the registered :class:`~repro_torch.core.strategies.AlgorithmSpec`.
PyTorch runs eagerly, so the round is a sequence of launches rather
than one compiled program.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import pytree as pt
from repro_torch.core import server
from repro_torch.core.client import make_batched_grad_fn, make_batched_solver
from repro_torch.core.strategies import (AlgorithmSpec, ControlCtx, CorrCtx,
                                         algorithm_spec, make_server_opt)


def _stack_zeros(w0, k: int):
    return pt.tmap(lambda x: x.new_zeros((k,) + x.shape), w0)


class RoundEngine:
    """Generic batched interpreter of one :class:`AlgorithmSpec`::

        round(w0, aux, phase_a, batches, valid, decay)
            -> (new_params, new_aux)

    - ``aux``: dict of the spec's persistent round state (``g_prev``,
      ``c_server``, ``controls`` as a K-selected stack, ``center``,
      ``opt``);
    - ``phase_a``: ``(batches, valid)`` of a separate gradient-gather
      selection, or ``None`` when the solve selection serves both
      phases or no fresh gather is needed;
    - ``decay``: ``spec.decay(cfg, t)`` (1.0 when undeclared).
    """

    def __init__(self, loss_fn: Callable, cfg,
                 spec: Optional[AlgorithmSpec] = None,
                 num_devices: Optional[int] = None):
        self.cfg = cfg
        self.spec = spec if spec is not None else algorithm_spec(
            cfg.algorithm)
        if self.spec.control_update is not None and num_devices is None:
            raise ValueError(
                f"spec {self.spec.name!r} updates control variates; "
                f"RoundEngine needs num_devices")
        self.num_devices = num_devices
        self._solver = make_batched_solver(
            loss_fn, learning_rate=cfg.learning_rate,
            num_epochs=cfg.local_epochs, solver=cfg.local_solver)
        self._grads = make_batched_grad_fn(loss_fn)
        self._server_opt = make_server_opt(self.spec, cfg)

    def round(self, w0, aux, phase_a, batches, valid, decay):
        spec, cfg = self.spec, self.cfg
        mu = cfg.mu if spec.use_mu else 0.0
        g_global = g_local = None
        if spec.grad_source == "fresh":
            if phase_a is None:
                # shared selection: one gradient pass serves the gather
                # AND the per-device corrections
                g_local = self._grads(w0, batches, valid)
                g_global = server.aggregate_stacked(g_local)
            else:
                g_global = server.aggregate_stacked(
                    self._grads(w0, phase_a[0], phase_a[1]))
                if spec.local_grad:
                    g_local = self._grads(w0, batches, valid)
        elif spec.grad_source == "stale":
            g_global = aux["g_prev"]
            g_local = self._grads(w0, batches, valid)

        if spec.correction is not None:
            corr = spec.correction(CorrCtx(
                w0=w0, g_global=g_global, g_local=g_local,
                c_server=aux.get("c_server"), c_local=aux.get("controls"),
                center=aux.get("center"), mu=mu, decay=decay))
        else:
            corr = _stack_zeros(w0, valid.shape[0])
        nsteps = cfg.local_epochs * valid.sum(dim=1)          # (K,)
        res = self._solver(w0, corr, mu, batches, valid)
        new = dict(aux)
        w_agg = server.aggregate_stacked(res.params)
        if spec.updates_g_prev:
            new["g_prev"] = server.aggregate_stacked(g_local)
        if spec.control_update is not None:
            c_new = spec.control_update(ControlCtx(
                c_local=aux["controls"], c_server=aux["c_server"], w0=w0,
                w_new=res.params,
                inv_steps=1.0 / (torch.clamp(nsteps, min=1.0)
                                 * cfg.learning_rate)))
            delta = server.aggregate_stacked(
                pt.sub(c_new, aux["controls"]))           # (1/K) sum_k
            k = float(valid.shape[0])
            new["c_server"] = pt.add(
                aux["c_server"], pt.scale(delta, k / self.num_devices))
            new["controls"] = c_new
        w_out, opt_state = server.server_step(
            w0, w_agg, self._server_opt, aux.get("opt"))
        if self._server_opt is not None:
            new["opt"] = opt_state
        if spec.center_update is not None:
            new["center"] = spec.center_update(aux["center"], w_out, cfg)
        return w_out, new

