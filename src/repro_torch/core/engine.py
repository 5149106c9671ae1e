"""Batched round engine: one federated round over K stacked devices.

Counterpart of the synchronous ``RoundEngine`` of ``repro/core/engine.py``
(``round_core``, with or without the client mesh).  The K selected
devices' padded batch stacks are stacked along a leading device axis,
phase-A gradients come
from one vmapped gradient pass, and the local solve runs in lockstep
through ``client.make_batched_solver`` -- on the card through the update
or fused local-solve kernels.  Devices whose stack is shorter take
masked identity steps, so each device's trajectory is the one the
looped reference gives it (parity at atol 1e-5).

Two programs share one body:

- :meth:`RoundEngine.round`, the ideal environment, exactly the
  pre-scenario round;
- :meth:`RoundEngine.round_env`, the scenario round: an ``active`` (K,)
  solve mask, a ``work`` (K,) fraction that truncates each device's
  steps, an ``active_a`` availability mask over the gradient gather,
  and a telemetry dict.

Under a lossy codec (``cfg.codec``) both aggregate the cohort through
the wire protocol (``codec_agg``): flat-packed deltas, the codec's
encode, ONE launch of the codec-aggregate kernel (K5), the codec's
decode.  ``codec="none"`` keeps the exact pre-codec program.

Under the client mesh (``mesh``, a
:class:`~repro_torch.core.sharding.ClientMesh`) each rank runs the same
round on its K/D rows -- the counterpart of the reference's
``shard_map``-ed round body: the stacked inputs hold the rank's rows,
every cross-client reduction (the means, the masked scenario
reductions, control deltas, telemetry counts) is summed over the ranks
through the aggregation tree (``sharding.tree_psum``/``tree_pmean``),
and the codec round launches K6 on the rank's slab, sums the partials
and the mask counts over the ranks and divides once.  Replicated state
(``w0``, ``g_prev``, ``c_server``, ``center``, server-optimizer state)
comes out equal on every rank.  ``mesh=None`` is the single-process
program, unchanged.

There is no per-algorithm code here: :class:`RoundEngine` interprets
the registered :class:`~repro_torch.core.strategies.AlgorithmSpec`.
PyTorch runs eagerly, so the round is a sequence of launches rather
than one compiled program.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import codecs
from repro_torch.core import pytree as pt
from repro_torch.core import server, sharding
from repro_torch.core.client import make_batched_grad_fn, make_batched_solver
from repro_torch.core.strategies import (AlgorithmSpec, ControlCtx, CorrCtx,
                                         algorithm_spec, make_server_opt)
from repro_torch.kernels import flatpack
from repro_torch.kernels.codec import codec_aggregate, codec_aggregate_partial


def _stack_zeros(w0, k: int):
    return pt.tmap(lambda x: x.new_zeros((k,) + x.shape), w0)


class RoundEngine:
    """Generic batched interpreter of one :class:`AlgorithmSpec`::

        round(w0, aux, phase_a, batches, valid, decay)
            -> (new_params, new_aux)
        round_env(w0, aux, phase_a, batches, valid, decay,
                  active, work, active_a)
            -> (new_params, new_aux, stats)

    - ``aux``: dict of the spec's persistent round state (``g_prev``,
      ``c_server``, ``controls`` as a K-selected stack, ``center``,
      ``opt``), plus under a lossy codec the round's ``codec_draws``
      and, for error-feedback codecs, the cohort's ``ef`` slabs
      ``(K, rows, 128)``;
    - ``phase_a``: ``(batches, valid)`` of a separate gradient-gather
      selection, or ``None`` when the solve selection serves both
      phases or no fresh gather is needed;
    - ``decay``: ``spec.decay(cfg, t)`` (1.0 when undeclared);
    - ``active``/``work``/``active_a``: the realized environment
      (``core/scenarios``), float ``(K,)`` tensors on the engine's
      device; ``stats`` holds ``intended_k``, ``effective_k``,
      ``dropped`` and ``effective_a`` (phase-A devices that served).

    Under ``mesh`` the K-stacked inputs (batches, ``valid``,
    ``controls``, ``ef``, the masks and ``phase_a``) hold this rank's
    rows, and so do the K-stacked outputs; everything else is global.
    """

    def __init__(self, loss_fn: Callable, cfg,
                 spec: Optional[AlgorithmSpec] = None,
                 num_devices: Optional[int] = None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.spec = spec if spec is not None else algorithm_spec(
            cfg.algorithm)
        if self.spec.control_update is not None and num_devices is None:
            raise ValueError(
                f"spec {self.spec.name!r} updates control variates; "
                f"RoundEngine needs num_devices")
        self.num_devices = num_devices
        self._codec = codecs.codec_spec(cfg.codec)
        self._codec_trivial = codecs.is_trivial(self._codec)
        self._solver = make_batched_solver(
            loss_fn, learning_rate=cfg.learning_rate,
            num_epochs=cfg.local_epochs, with_cutoff=True,
            solver=cfg.local_solver)
        self._grads = make_batched_grad_fn(loss_fn)
        self._server_opt = make_server_opt(self.spec, cfg)

    def round(self, w0, aux, phase_a, batches, valid, decay):
        return self._round(w0, aux, phase_a, batches, valid, decay,
                           None, None, None)

    def round_env(self, w0, aux, phase_a, batches, valid, decay, active,
                  work, active_a):
        return self._round(w0, aux, phase_a, batches, valid, decay,
                           active, work, active_a)

    def _codec_agg(self, w0, params_stack, aux, new, active):
        """Wire-protocol aggregate: the cohort's pseudo-gradient deltas
        on the flat-packed ``(K, rows, 128)`` layout, encoded by the
        codec (consuming and refreshing the error feedback in
        ``aux["ef"]``), reduced by ONE K5 launch, server-decoded.  Under
        the mesh: one K6 launch on the rank's slab, its partial and mask
        count summed over the ranks, divided once."""
        codec, cfg = self._codec, self.cfg
        fspec = flatpack.flat_spec(w0)
        kk = pt.leaves(params_stack)[0].shape[0]
        deltas = (flatpack.pack_broadcast(fspec, w0, kk)
                  - flatpack.pack_stacked(fspec, params_stack, kk)
                  ).reshape(kk, fspec.rows, flatpack.LANES)
        draws = aux.get("codec_draws")
        efs = aux.get("ef")
        vals, scales, ef_new = codecs.encode_stacked(codec, cfg, draws,
                                                     deltas, efs)
        mask = (active if active is not None
                else torch.ones(kk, dtype=torch.float32,
                                device=deltas.device))
        if self.mesh is None:
            agg = codec_aggregate(vals, scales, mask)
            cnt = mask.sum()
        else:
            num = sharding.tree_psum(
                codec_aggregate_partial(vals, scales, mask), self.mesh)
            cnt = sharding.tree_psum(mask.sum(), self.mesh)
            agg = num / torch.clamp(cnt, min=1.0)
        # the post stages read the round's shared draws, so every rank
        # applies the same transform
        agg = codecs.decode_aggregate(codec, cfg, draws, agg, cnt)
        if ef_new is not None:
            if active is not None:
                # offline clients never transmitted: their error
                # feedback is untouched this round
                ef_new = torch.where(active.reshape(-1, 1, 1) > 0,
                                     ef_new, efs)
            new["ef"] = ef_new
        return pt.sub(w0, flatpack.unpack(fspec, agg))

    def _round(self, w0, aux, phase_a, batches, valid, decay, active,
               work, active_a):
        spec, cfg, mesh = self.spec, self.cfg, self.mesh
        shards = sharding.num_shards(mesh)
        with_env = active is not None
        mu = cfg.mu if spec.use_mu else 0.0
        g_global = g_local = None
        grad_ok = avail_n = None
        if spec.grad_source == "fresh":
            if with_env:
                # offline devices serve no gradient either: g_t is the
                # masked mean over the available gather selection; with
                # none available there is no correction (grad_ok)
                zeros = pt.zeros_like(w0)
                avail_n = sharding.tree_psum(active_a.sum(), mesh)
                grad_ok = (avail_n > 0).to(torch.float32)
            if phase_a is None:
                # shared selection: one gradient pass serves the gather
                # AND the per-device corrections
                g_local = self._grads(w0, batches, valid)
                g_global = (server.aggregate_stacked_masked(
                    g_local, active_a, zeros, mesh) if with_env
                    else server.aggregate_stacked(g_local, mesh))
            else:
                ga = self._grads(w0, phase_a[0], phase_a[1])
                g_global = (server.aggregate_stacked_masked(
                    ga, active_a, zeros, mesh) if with_env
                    else server.aggregate_stacked(ga, mesh))
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
            if grad_ok is not None:
                # no reachable gradient device -> no broadcast -> the
                # round runs uncorrected
                corr = pt.tmap(lambda c: c * grad_ok, corr)
        else:
            corr = _stack_zeros(w0, valid.shape[0])
        nsteps = cfg.local_epochs * valid.sum(dim=1)          # (K,)
        if with_env:
            # devices stop after ceil(work * total) of their valid steps
            nsteps = torch.minimum(torch.ceil(work * nsteps), nsteps)
            res = self._solver(w0, corr, mu, batches, valid, nsteps)
        else:
            res = self._solver(w0, corr, mu, batches, valid)
        new = dict(aux)
        new.pop("codec_draws", None)
        if self._codec_trivial:
            w_agg = (server.aggregate_stacked_masked(res.params, active, w0,
                                                     mesh)
                     if with_env
                     else server.aggregate_stacked(res.params, mesh))
        else:
            w_agg = self._codec_agg(w0, res.params, aux, new, active)
        if spec.updates_g_prev:
            new["g_prev"] = (
                server.aggregate_stacked_masked(g_local, active,
                                                aux["g_prev"], mesh)
                if with_env else server.aggregate_stacked(g_local, mesh))
        if spec.control_update is not None:
            c_new = spec.control_update(ControlCtx(
                c_local=aux["controls"], c_server=aux["c_server"], w0=w0,
                w_new=res.params,
                inv_steps=1.0 / (torch.clamp(nsteps, min=1.0)
                                 * cfg.learning_rate)))
            if with_env:
                # only devices whose update reached the server refresh
                # their control and feed the server control
                def keep(n, o):
                    a = active.reshape(active.shape + (1,) * (n.ndim - 1))
                    return torch.where(a > 0, n, o)
                c_new = pt.tmap(keep, c_new, aux["controls"])
                delta_sum = pt.tmap(
                    lambda n, o: sharding.tree_psum((n - o).sum(dim=0),
                                                    mesh),
                    c_new, aux["controls"])
                new["c_server"] = pt.tmap(
                    lambda cs, d: cs + d / float(self.num_devices),
                    aux["c_server"], delta_sum)
            else:
                delta = server.aggregate_stacked(
                    pt.sub(c_new, aux["controls"]), mesh)  # (1/K) sum_k
                k = float(valid.shape[0] * shards)
                new["c_server"] = pt.add(
                    aux["c_server"], pt.scale(delta, k / self.num_devices))
            new["controls"] = c_new
        w_out, opt_state = server.server_step(
            w0, w_agg, self._server_opt, aux.get("opt"))
        if self._server_opt is not None:
            new["opt"] = opt_state
        if spec.center_update is not None:
            new["center"] = spec.center_update(aux["center"], w_out, cfg)
        if with_env:
            k = float(valid.shape[0] * shards)
            eff = sharding.tree_psum(active.sum(), mesh)
            # effective_a: devices that served the fresh gradient gather
            # (0 for stale and gradient-free specs)
            stats = {"intended_k": k, "effective_k": eff,
                     "dropped": k - eff,
                     "effective_a": (avail_n if avail_n is not None
                                     else torch.zeros((), device=eff.device))}
            return w_out, new, stats
        return w_out, new
