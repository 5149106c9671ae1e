"""Federated optimization trainer (paper Alg. 1 & 2 + §V-C variants).

Counterpart of ``repro/core/algorithms.py``.  ``FederatedTrainer``
interprets the registered
:class:`~repro_torch.core.strategies.AlgorithmSpec` of
``cfg.algorithm`` on one of two engines (``FederatedConfig.engine``):

- ``"batched"``: the K selected devices stacked and solved in lockstep
  by :class:`~repro_torch.core.engine.RoundEngine` -- on the card
  through the hand-written kernels;
- ``"loop"``: the per-device reference with plain tree-op updates;
- ``"auto"`` (default): batched on the card, loop on the CPU, and
  batched under the client mesh on either.

``run()`` drives the rounds with one of three drivers
(``FederatedConfig.round_driver``): ``"python"``, a host loop over
:meth:`FederatedTrainer.round`; ``"scan"``, the
:class:`~repro_torch.core.engine.ScannedDriver` (on-card sampling, one
captured CUDA graph a round on the card, split at its collectives on
the client mesh); or ``"buffered"``, the asynchronous
:class:`~repro_torch.core.async_engine.BufferedDriver` (an event queue
of stale clients, ``num_rounds`` counting server commits).  ``"auto"``
is ``"scan"`` wherever the engine resolved to ``batched`` -- on the
card, under the client mesh, or ``engine="batched"`` on the CPU -- as
in the reference.  A control-variate spec with replacement runs on
``"python"`` under either.

Orthogonally, ``cfg.scenario`` selects a registered environment
(``core/scenarios``: availability, stragglers, dropout, partial work),
realized once per round as an ``active`` mask and ``work`` fractions
for the solve selection plus an availability mask for the gradient
gather, and ``cfg.codec`` a registered wire codec (``core/codecs``):
update deltas are encoded and the cohort aggregated through the codec
kernel (K5) on both engines.  ``"ideal"`` and ``"none"`` keep the exact
pre-scenario, pre-codec programs.

A streaming dataset (``data/shard_source.py``, ``weights=None``) runs
on all three drivers: sampling is uniform, cohorts are fetched from the
source, SCAFFOLD controls and error feedback live in sparse stores keyed
by client id, and the global loss runs over the source's bounded eval
sample; nothing on the python driver touches all N clients' data
(``measure_dissimilarity`` refuses a source).  On the client mesh each
rank generates only its rows of a cohort (the cohort's batch count
comes from the clients' sizes, ``num_batches``).

On the python driver, sampling and the scenario uniforms use the
reference's numpy stream (``default_rng(cfg.seed)``, the same calls in
the same order), so a seed gives the reference's selections and
environment under either engine; the scanned driver draws both on its
own device (see its docstring).  The trainer runs on ``device`` -- the card unless
``device="cpu"`` -- and the dataset must live there; the environment is
realized on the host, so the card and the CPU see the same masks.

Under the client mesh (``cfg.mesh_devices``, ``cfg.edge_shards``; the
ranks started by ``core.sharding.run_on_mesh``, each building its own
trainer with the :class:`~repro_torch.core.sharding.ClientMesh` it was
handed) every rank samples, realizes the environment, draws and
evaluates exactly as the single process does, then solves only its K/D
rows of the cohort: the stacks are padded to the whole cohort's batch
count, so every rank takes the same solver mode and shapes.  Per-client
state (SCAFFOLD controls, codec error feedback) stays full-N on every
rank on this driver: after a round each rank's updated rows reach all
ranks (``sharding.gather_rows``) and every rank scatters the same K
rows.  The scanned and buffered drivers take the mesh from the trainer
(their docstrings say how they split the work).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import codecs
from repro_torch.core import pytree as pt
from repro_torch.core import server, sharding
from repro_torch.core.async_engine import BufferedDriver
from repro_torch.core.client import (make_eval_loss, make_grad_fn,
                                     make_local_solver)
from repro_torch.core.engine import RoundEngine, ScannedDriver, new_history
from repro_torch.core.scenarios import (availability_mask, env_channels,
                                        is_trivial, realize_env,
                                        scenario_spec)
from repro_torch.core.strategies import (ControlCtx, CorrCtx, algorithm_spec,
                                         init_aux, make_server_opt,
                                         runtime_state_fields)
from repro_torch.core.theory import b_dissimilarity
from repro_torch.data.batching import num_batches_of, stack_device_batches
from repro_torch.data.shard_source import resolve_streaming
from repro_torch.device import resolve_device
from repro_torch.kernels import flatpack
from repro_torch.kernels.codec import codec_aggregate


@dataclass
class FederatedState:
    """Mutable run state threaded between rounds: global params,
    counters, and whichever persistent state the spec declares."""

    params: Any
    round: int = 0
    comm_rounds: int = 0
    g_prev: Any = None                    # pipelined FedDANE stale gradient
    controls: Any = None                  # SCAFFOLD per-device c_k
    c_server: Any = None                  # SCAFFOLD server c
    center: Any = None                    # S-DANE auxiliary prox center
    opt_state: Any = None                 # server-optimizer state
    ef: Any = None                        # codec per-device error feedback


class FederatedTrainer:
    """Simulates N devices + central server on one host (paper §V).

    ``dataset`` provides ``num_devices``, ``weights`` (p_k),
    ``device_batches(k)`` and ``eval_batches()``, with tensors on
    ``device``; ``loss_fn(params, batch) -> scalar`` must work under
    ``torch.func.grad``/``vmap``.  ``mesh``: this rank's
    :class:`~repro_torch.core.sharding.ClientMesh` when
    ``cfg.mesh_devices`` asks for the client mesh; the trainer then runs
    on the mesh's device unless ``device`` names it.
    """

    def __init__(self, loss_fn: Callable, dataset, cfg: FederatedConfig,
                 device=None, mesh=None):
        #: the client mesh (core/sharding.py), or None: one process
        self.mesh = sharding.mesh_for(cfg, mesh)
        if self.mesh is not None:
            if device is None:
                device = self.mesh.device
            elif torch.device(device) != self.mesh.device:
                raise ValueError(f"trainer device {device} is not this "
                                 f"rank's mesh device {self.mesh.device}")
        self.device = resolve_device(device)
        data_dev = getattr(dataset, "device", None)
        if data_dev is not None and torch.device(data_dev) != self.device:
            raise ValueError(f"dataset lives on {data_dev}, trainer runs "
                             f"on {self.device}")
        self.loss_fn = loss_fn
        self.dataset = dataset
        self.cfg = cfg
        self.spec = algorithm_spec(cfg.algorithm)
        # the trivial "ideal" scenario and "none" codec keep every path
        # below exactly pre-scenario and pre-codec: no draws, no masks,
        # no packing
        self.scn = scenario_spec(cfg.scenario)
        self._scn_trivial = is_trivial(self.scn)
        self._env_channels = env_channels(self.scn)
        self.codec = codecs.codec_spec(cfg.codec)
        self._codec_trivial = codecs.is_trivial(self.codec)
        #: (S1, S2) of the most recent round
        self.last_selection: Optional[Tuple[np.ndarray, np.ndarray]] = None
        #: (phase-A availability mask, solve ``active`` mask) of the most
        #: recent round as numpy arrays, ``None`` under the ideal scenario
        self.last_masks: Optional[Tuple[np.ndarray, np.ndarray]] = None
        #: (intended K, effective K) of the most recent round
        self.last_env: Optional[Tuple[int, float]] = None
        #: (phase-A gather devices that responded, solve devices whose
        #: update arrived) of the last round -- the byte accounting's input
        self.last_comm: Optional[Tuple[float, float]] = None
        self.rng = np.random.default_rng(cfg.seed)
        self.solver = make_local_solver(
            loss_fn, learning_rate=cfg.learning_rate,
            num_epochs=cfg.local_epochs)
        self._solver_cut = None       # cutoff variant, built on demand
        self.grad_fn = make_grad_fn(loss_fn)
        self._server_opt = make_server_opt(self.spec, cfg)
        self._state_fields = runtime_state_fields(self.spec, cfg)
        engine = cfg.engine
        if engine == "auto":
            # the mesh runs the batched round, on the CPU too
            engine = ("batched" if self.device.type == "cuda"
                      or self.mesh is not None else "loop")
        if self.mesh is not None:
            if engine == "loop":
                raise ValueError(
                    "mesh_devices > 1 requires the batched engine: the "
                    "looped per-device reference path is single-process "
                    "by construction (set engine='batched' or 'auto', or "
                    "mesh_devices=1)")
            if self.spec.num_selections == 0:
                sharding.check_divisible(
                    dataset.num_devices, self.mesh,
                    "num_devices (full-participation spec)")
            else:
                k = (cfg.devices_per_round if cfg.sample_with_replacement
                     else min(cfg.devices_per_round, dataset.num_devices))
                sharding.check_divisible(k, self.mesh, "devices_per_round")
        self.engine: Optional[RoundEngine] = (
            RoundEngine(loss_fn, cfg, spec=self.spec,
                        num_devices=dataset.num_devices, mesh=self.mesh)
            if engine == "batched" else None)
        #: the dataset is a streaming source (``data/shard_source.py``)
        self.streaming = resolve_streaming(cfg.client_source, dataset)
        self._scanned: Optional[ScannedDriver] = None   # built lazily
        # built here, so an unsupported configuration fails fast
        self._buffered: Optional[BufferedDriver] = (
            BufferedDriver(loss_fn, dataset, cfg, device=self.device,
                           mesh=self.mesh)
            if cfg.round_driver == "buffered" else None)
        self._sample_queue: List[np.ndarray] = []       # test injection
        self._eval_loss = make_eval_loss(loss_fn)

    # -- helpers ----------------------------------------------------------

    def _sample(self) -> np.ndarray:
        if self._sample_queue:
            return np.asarray(self._sample_queue.pop(0), dtype=np.int64)
        p = self.dataset.weights if self.cfg.weighted_sampling else None
        return server.sample_devices(
            self.rng, self.dataset.num_devices, self.cfg.devices_per_round,
            p=p, replace=self.cfg.sample_with_replacement)

    def _resolve_driver(self) -> str:
        """The driver ``run()`` takes (module docstring)."""
        driver = self.cfg.round_driver
        if driver == "buffered":
            return driver
        if driver == "auto":
            driver = "scan" if self.engine is not None else "python"
        if (driver == "scan" and self.spec.control_update is not None
                and self.cfg.sample_with_replacement):
            # duplicated selections need sequential control updates; the
            # scanned scatter applies them once
            driver = "python"
        return driver

    def _batches(self, k: int):
        return self.dataset.device_batches(int(k))

    def _stack(self, S, lo: int, hi: int):
        """Rows ``lo:hi`` of selection ``S`` stacked for the batched
        engine; under the mesh padded to the whole cohort's batch count,
        so that every rank takes the same solver mode and shapes."""
        if self.mesh is None:
            return stack_device_batches(self.dataset, S)
        # a streaming source tells the counts without generating clients
        nb = max(self.dataset.num_batches(k) for k in S)
        return stack_device_batches(self.dataset, S[lo:hi], nb=nb)

    def init(self, params) -> FederatedState:
        """Fresh state at round 0 for ``params`` (moved to the trainer's
        device), with the spec's persistent state initialized."""
        params = pt.tmap(lambda x: x.to(self.device), params)
        st = FederatedState(params=params)
        aux = init_aux(self.spec, self.cfg, params,
                       self.dataset.num_devices)
        st.g_prev = aux.get("g_prev")
        st.controls = aux.get("controls")
        st.c_server = aux.get("c_server")
        st.center = aux.get("center")
        st.opt_state = aux.get("opt")
        st.ef = codecs.init_ef(self.codec, flatpack.flat_spec(params),
                               self.dataset.num_devices, self.device)
        return st

    def _gather_aux(self, st: FederatedState, S) -> Dict[str, Any]:
        aux: Dict[str, Any] = {}
        for f in self._state_fields:
            if f == "g_prev":
                aux["g_prev"] = st.g_prev
            elif f == "center":
                aux["center"] = st.center
            elif f == "opt":
                aux["opt"] = st.opt_state
            elif f == "controls":
                aux["c_server"] = st.c_server
                aux["controls"] = st.controls.gather(S)
        return aux

    def _scatter_aux(self, st: FederatedState, aux: Dict[str, Any],
                     S) -> None:
        for f in self._state_fields:
            if f == "g_prev":
                st.g_prev = aux["g_prev"]
            elif f == "center":
                st.center = aux["center"]
            elif f == "opt":
                st.opt_state = aux["opt"]
            elif f == "controls":
                st.c_server = aux["c_server"]
                st.controls.scatter(S, aux["controls"])

    # -- the generic round ------------------------------------------------

    def round(self, st: FederatedState) -> FederatedState:
        """Advance one federated round in place and return ``st``:
        sample the spec's selections, realize the scenario, and interpret
        the spec on the configured engine."""
        spec, cfg = self.spec, self.cfg
        w0 = st.params
        mu = cfg.mu if spec.use_mu else 0.0
        decay = (spec.decay(cfg, st.round)
                 if spec.decay is not None else 1.0)
        eng = self.engine
        # duplicated selections must update controls sequentially; the
        # batched scatter would apply them once -> the looped path (under
        # the mesh every rank then runs the whole looped round alike)
        if spec.control_update is not None and cfg.sample_with_replacement:
            eng = None

        if spec.num_selections == 0:
            S1 = S2 = np.arange(self.dataset.num_devices)
        elif spec.num_selections == 1:
            S1 = S2 = self._sample()
        else:
            S1, S2 = self._sample(), self._sample()
        shared = S1 is S2 and spec.grad_source == "fresh"
        self.last_selection = (S1, S2)

        # The environment of the solve selection: one per-DEVICE (N,)
        # uniform per declared channel, in fixed order, from the sampling
        # stream; realized on the host in float32 (ideal draws nothing)
        active = work = active_a = None
        if not self._scn_trivial:
            n = self.dataset.num_devices
            uniforms = {c: torch.from_numpy(self.rng.random(n)).to(
                torch.float32) for c in self._env_channels}
            env = realize_env(self.scn, cfg, n, torch.from_numpy(S2),
                              st.round, uniforms)
            active, work = env.active, env.work
            if spec.grad_source == "fresh":
                # availability gates phase A too (same per-device draws)
                active_a = availability_mask(self.scn, cfg, n,
                                             torch.from_numpy(S1),
                                             st.round, uniforms)
            self.last_masks = (
                None if active_a is None else active_a.numpy(),
                active.numpy())
            self.last_env = (len(S2), float(active.sum()))
        else:
            self.last_masks = None
            self.last_env = (len(S2), float(len(S2)))
        # phase-A gradients cost bytes only for the devices that
        # responded: under availability scenarios the thinned gather
        if spec.grad_source == "fresh":
            gather_n = (float(len(S1)) if active_a is None
                        else float(active_a.sum()))
        else:
            gather_n = 0.0
        self.last_comm = (gather_n, self.last_env[1])

        if eng is not None:
            # this rank's rows of the cohort (all of them without a mesh)
            lo, hi = sharding.shard_rows(len(S2), self.mesh)
            b, v = self._stack(S2, lo, hi)
            phase_a = (self._stack(S1, lo, hi)
                       if spec.grad_source == "fresh" and not shared
                       else None)
            aux = self._gather_aux(st, S2[lo:hi])
            if not self._codec_trivial:
                aux["codec_draws"] = codecs.round_draws(
                    self.codec, cfg, st.round, hi - lo,
                    flatpack.flat_spec(w0).rows, self.device, idx0=lo)
                if self.codec.error_feedback:
                    aux["ef"] = st.ef.gather(S2[lo:hi])

            def rows(x):
                return None if x is None else x[lo:hi].to(self.device)

            if active is None:
                st.params, aux_new = eng.round(w0, aux, phase_a, b, v,
                                               decay)
            else:
                st.params, aux_new, _ = eng.round_env(
                    w0, aux, phase_a, b, v, decay, rows(active),
                    rows(work), rows(active_a))
            if self.mesh is not None:
                # every rank's updated rows, on every rank
                for f in ("controls", "ef"):
                    if f in aux_new:
                        aux_new[f] = sharding.gather_rows(aux_new[f],
                                                          self.mesh)
            self._scatter_aux(st, aux_new, S2)
            if not self._codec_trivial and self.codec.error_feedback:
                st.ef.scatter(S2, aux_new["ef"])
        else:
            self._loop_round(
                st, S1, S2, mu, decay,
                active=None if active is None else active.numpy() > 0,
                work=None if work is None else work.numpy(),
                avail_a=None if active_a is None else active_a.numpy() > 0)
        st.comm_rounds += spec.comm_per_round
        st.round += 1
        return st

    def _solve_partial(self, w0, corr, mu, bk, limit: int):
        """Local solve truncated to ``limit`` SGD steps; the cutoff
        solver is built on first use."""
        if self._solver_cut is None:
            self._solver_cut = make_local_solver(
                self.loss_fn, learning_rate=self.cfg.learning_rate,
                num_epochs=self.cfg.local_epochs, with_cutoff=True)
        return self._solver_cut(w0, corr, mu, bk, limit)

    def _loop_round(self, st: FederatedState, S1, S2, mu, decay,
                    active=None, work=None, avail_a=None) -> None:
        """Per-device reference interpretation of the spec: one solve or
        gradient call per device, plain tree-op aggregation.

        ``active``/``work``/``avail_a`` (the realized environment, None
        under the ideal scenario): ``avail_a`` thins the phase-A gather
        to the available part of S1 (with none available there is no
        g_t and the round runs uncorrected); inactive solve devices are
        skipped outright; partial-work devices stop after
        ``ceil(work * steps)`` steps.  With no active device the round
        is a no-op (``w_agg = w0``).
        """
        spec, cfg = self.spec, self.cfg
        w0 = st.params
        zeros = pt.zeros_like(w0)

        g_global = None
        if spec.grad_source == "fresh":
            S1_avail = (S1 if avail_a is None
                        else [k for i, k in enumerate(S1) if avail_a[i]])
            if len(S1_avail) > 0:
                g_global = server.aggregate_gradients(
                    [self.grad_fn(w0, self._batches(k)) for k in S1_avail])
        elif spec.grad_source == "stale":
            g_global = st.g_prev

        c0 = st.c_server
        updates, upd_ids, fresh_grads, deltas = [], [], [], []
        for i, k in enumerate(S2):
            if active is not None and not active[i]:
                continue
            bk = self._batches(k)
            g_local = self.grad_fn(w0, bk) if spec.local_grad else None
            if spec.updates_g_prev:
                fresh_grads.append(g_local)
            if spec.correction is not None and not (
                    spec.grad_source == "fresh" and g_global is None):
                corr = spec.correction(CorrCtx(
                    w0=w0, g_global=g_global, g_local=g_local,
                    c_server=c0,
                    c_local=(st.controls[int(k)]
                             if st.controls is not None else None),
                    center=st.center, mu=mu, decay=decay))
            else:
                corr = zeros
            total = cfg.local_epochs * num_batches_of(bk)
            nsteps = (min(total, int(np.ceil(work[i] * total)))
                      if work is not None else total)
            if nsteps < total:
                res = self._solve_partial(w0, corr, mu, bk, nsteps)
            else:
                res = self.solver(w0, corr, mu, bk)
            updates.append(res.params)
            upd_ids.append(int(k))
            if spec.control_update is not None:
                # option II: corrections used the ROUND-START server
                # control; duplicates refresh the device control in turn
                ck_new = spec.control_update(ControlCtx(
                    c_local=st.controls[int(k)], c_server=c0, w0=w0,
                    w_new=res.params,
                    inv_steps=1.0 / (max(nsteps, 1) * cfg.learning_rate)))
                deltas.append(pt.sub(ck_new, st.controls[int(k)]))
                st.controls[int(k)] = ck_new

        if self._codec_trivial or not updates:
            w_agg = server.aggregate_mean(updates) if updates else w0
        else:
            w_agg = self._codec_aggregate(st, w0, updates, upd_ids)
        if spec.control_update is not None and deltas:
            st.c_server = pt.add(
                c0, pt.scale(pt.mean(deltas),
                             len(deltas) / self.dataset.num_devices))
        if spec.updates_g_prev and fresh_grads:
            st.g_prev = server.aggregate_gradients(fresh_grads)
        st.params, st.opt_state = server.server_step(
            w0, w_agg, self._server_opt, st.opt_state)
        if spec.center_update is not None:
            st.center = spec.center_update(st.center, st.params, cfg)

    def _codec_aggregate(self, st: FederatedState, w0, updates, ids):
        """The wire stage of the looped path: each active client's delta
        ``w0 - w_k`` flat-packed and encoded in cohort slots ``0..k-1``
        (the reference's numbering on this path), the cohort reduced by
        K5 with an all-ones mask, then the codec's decode."""
        codec, cfg = self.codec, self.cfg
        k = len(updates)
        fspec = flatpack.flat_spec(w0)
        deltas = (flatpack.pack_broadcast(fspec, w0, k)
                  - flatpack.pack_stacked(fspec, pt.stack(updates), k)
                  ).reshape(k, fspec.rows, flatpack.LANES)
        draws = codecs.round_draws(codec, cfg, st.round, k, fspec.rows,
                                   self.device)
        efs = st.ef.gather(ids) if codec.error_feedback else None
        vals, scales, ef_new = codecs.encode_stacked(codec, cfg, draws,
                                                     deltas, efs)
        agg = codec_aggregate(vals, scales, torch.ones(
            k, dtype=torch.float32, device=deltas.device))
        agg = codecs.decode_aggregate(codec, cfg, draws, agg, k)
        if ef_new is not None:
            # in order: a device selected twice keeps the last residual
            st.ef.scatter(ids, ef_new)
        return pt.sub(w0, flatpack.unpack(fspec, agg))

    # -- evaluation -------------------------------------------------------

    def global_loss(self, params) -> float:
        """f(w) = sum_k p_k F_k(w)  (eq. 1)."""
        weights, losses = [], []
        for wk, batches in self.dataset.eval_batches():
            weights.append(wk)
            losses.append(self._eval_loss(params, batches))
        total, wsum = 0.0, 0.0
        for wk, loss in zip(weights, torch.stack(losses).tolist()):
            total += wk * loss
            wsum += wk
        return total / max(wsum, 1e-12)

    def measure_dissimilarity(self, params) -> float:
        """B-local dissimilarity (paper Def. 2) at ``params``, measured
        over ALL devices' full local gradients, weighted by the devices'
        p_k -- the heterogeneity instrumentation behind the §V
        analysis."""
        if self.streaming:
            raise ValueError(
                "measure_dissimilarity takes every client's full gradient "
                "and its p_k; a streaming source holds neither (sampling "
                "over it is uniform, and touching all N clients is what "
                "it avoids): measure it on source.materialize() at small N")
        grads = [self.grad_fn(params, self._batches(k))
                 for k in range(self.dataset.num_devices)]
        return b_dissimilarity(grads, self.dataset.weights)

    def run(self, params, num_rounds: int, eval_every: int = 1,
            verbose: bool = False, checkpoint_dir: Optional[str] = None,
            selections=None) -> Tuple[Dict[str, List[float]], Any]:
        """Run ``num_rounds`` rounds; returns ``(history, final_params)``
        with the reference's history keys: ``round`` / ``comm_rounds`` /
        ``loss`` at eval cadence, and per round the realized
        participation ``intended_k`` / ``effective_k`` / ``dropped`` (K /
        K / 0 under the ideal scenario) and the codec's honest wire bytes
        ``bytes_up`` / ``bytes_down`` (``codecs.round_bytes``).

        ``checkpoint_dir``: if set, ``{"params", "round"}`` is saved
        (``checkpoint/store.py``, the reference's format and file names)
        every ``cfg.chunk_rounds`` rounds and after the last round.
        ``selections``: optional ``(num_rounds, 2, K)`` (or
        ``(num_rounds, K)``) int array overriding device sampling round
        by round -- row 0 feeds single-selection algorithms and FedDANE
        phase A, row 1 phase B.
        """
        driver = self._resolve_driver()
        if driver == "buffered":
            # num_rounds counts server commits; the history adds the
            # per-commit staleness telemetry
            return self._buffered.run(
                params, num_rounds, eval_every=eval_every, verbose=verbose,
                checkpoint_dir=checkpoint_dir, selections=selections)
        if driver == "scan":
            if self._scanned is None:
                self._scanned = ScannedDriver(
                    self.loss_fn, self.dataset, self.cfg,
                    engine=self.engine, device=self.device)
            return self._scanned.run(
                params, num_rounds, eval_every=eval_every, verbose=verbose,
                checkpoint_dir=checkpoint_dir, selections=selections)
        if selections is not None:
            sel = np.asarray(selections)
            if sel.shape[0] < num_rounds:
                raise ValueError(
                    f"selections covers {sel.shape[0]} rounds "
                    f"< num_rounds={num_rounds}")
            two_phase = self.spec.num_selections == 2
            for t in range(num_rounds):
                row = sel[t]
                phases = [row] if row.ndim == 1 else list(row)
                self._sample_queue.append(phases[0])
                if two_phase:
                    self._sample_queue.append(
                        phases[1] if len(phases) > 1 else phases[0])

        chunk = (self.cfg.chunk_rounds if self.cfg.chunk_rounds > 0
                 else num_rounds)
        st = self.init(params)
        n_elems = sum(x.numel() for x in pt.leaves(st.params))
        hist = new_history()
        try:
            for t in range(num_rounds):
                st = self.round(st)
                intended, eff = self.last_env
                hist["intended_k"].append(float(intended))
                hist["effective_k"].append(eff)
                hist["dropped"].append(float(intended) - eff)
                up, down = codecs.round_bytes(self.spec, self.codec,
                                              self.cfg, n_elems,
                                              *self.last_comm)
                hist["bytes_up"].append(up)
                hist["bytes_down"].append(down)
                if t % eval_every == 0 or t == num_rounds - 1:
                    loss = self.global_loss(st.params)
                    hist["round"].append(st.round)
                    hist["comm_rounds"].append(st.comm_rounds)
                    hist["loss"].append(loss)
                    if verbose:
                        print(f"[{self.cfg.algorithm}] round {st.round:4d} "
                              f"comm {st.comm_rounds:4d} loss {loss:.4f}")
                if checkpoint_dir is not None and (
                        (t + 1) % chunk == 0 or t == num_rounds - 1):
                    save_checkpoint(checkpoint_dir,
                                    {"params": st.params,
                                     "round": st.round},
                                    step=st.round)
        finally:
            # injected selections must never leak into a later run()
            self._sample_queue.clear()
        return hist, st.params

