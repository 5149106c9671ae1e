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

Scanned multi-round driver
--------------------------
:class:`ScannedDriver` (``make_scanned_run``) is the layer above,
counterpart of the reference's stacked-plan ``ScannedDriver``.  Where the
reference fuses ``chunk_rounds`` rounds into one ``lax.scan`` program,
the port captures ONE round as a CUDA graph and replays it once a round,
so the host issues one launch where it would issue hundreds of kernels:

- **on-card sampling**: selections come from
  ``server.sample_devices_onchip`` on the driver's ``torch.Generator``
  (registered with the graph, so every replay draws anew) and gather
  rows of the pre-stacked all-device batch tensors, every device padded
  to the dataset-wide ``nb_max``, so shapes stay fixed across rounds;
  SCAFFOLD controls and error-feedback slabs are gathered and scattered
  back (``index_copy_``) the same way.  Injected selections
  (``selections=``) are read from a staged buffer by a second program.
  Host and card samplers share the distribution, not the bit stream
  (core/server.py);
- **round-indexed values staged per chunk**: ``decay^t``, the scenario's
  availability ``p_t`` and the codec draws depend on the round index,
  which a captured graph would freeze, so the host computes them for
  every round of a chunk (the same ``f32math`` on the CPU, the same
  ``codecs.round_draws`` as the python driver) and stages them; the
  captured round reads row ``i`` of each through an on-card counter it
  advances itself.  The environment's uniforms are drawn in the graph
  (:func:`scan_env_uniforms`) and realized on the card
  (``scenarios.realize_env_staged``);
- **in-driver eval**: the p_k-weighted global loss over the all-device
  stacked eval tensors is a second captured program, replayed after
  each round whose eval the host's mask asks for (the reference's
  ``lax.cond``);
- **chunked execution**: losses and the scenario telemetry stay on the
  card until the chunk boundary, the only host sync, where the history
  is emitted and checkpoints are saved.

The client mesh
---------------
On the mesh (the engine's ``mesh``) every rank runs the same driver
from the same seed, so selections, environments and replicated state
are equal on every rank, and solves its K/D rows of each cohort:

- **layout**: where D divides N, each rank keeps only its N/D clients'
  all-device stacks (train and eval rows, SCAFFOLD controls, error
  feedback); otherwise they are replicated, with a warning.  The run
  history's ``sharded`` records which, a value a round (the reference's
  telemetry); streaming records 1.0;
- **gather and scatter**: a cohort's rows leave a sharded layout in one
  exchange (``sharding.gather_selected``: each rank fills the rows it
  holds into zero ``(K, ...)`` stacks, one all-reduce step, the rank
  keeps its rows), and updated rows go back the same way, each rank
  writing the ids it holds (``sharding.scatter_selected``);
- **eval**: each rank's rows' weighted losses, summed over the ranks;
- **capture**: the round contains all-reduces, which gloo runs through
  the host, so the program is captured as CUDA-graph segments split at
  them (``sharding.SegmentedGraph``) and replayed segment by segment
  with the all-reduces between; the warm-up issues them eagerly;
- **streaming**: the schedule pass is the same on every rank; a rank
  stages (and so generates) only its rows of each cohort, and the
  updated state rows reach every rank's stores through
  ``sharding.gather_rows`` at the chunk boundary.

The streaming plan
------------------
Over a :class:`~repro_torch.data.shard_source.ClientShardSource`
(``client_source="streaming"``, or ``"auto"`` with a source) nothing
O(N) is stacked -- the counterpart of the reference's streaming
``ScannedDriver``.  Each chunk:

- **schedule pass**: the round's draws made eagerly on the driver's
  generator, in the order the stacked round makes them (``s1``, ``s2``,
  the environment's uniforms), the environment realized on the driver's
  device (work fractions eagerly, as the reference's streaming schedule
  does), and one host sync for the chunk's selections and masks.  A
  stateful spec (SCAFFOLD controls, error feedback) ends the chunk
  before the first round whose cohort repeats a client of the chunk,
  and the generator goes back to that round's state;
- **staging**: only the chunk's cohorts, from the source, padded to one
  chunk-wide batch count ``nb`` (the reference's ``_pad_cohort``), with
  the cohorts' rows of the sparse stores (``controls_store``, ``ef_store``) and the
  realized masks, into staged buffers of that ``nb``;
- **the streaming round**: the engine's round on row ``i`` of the
  staged buffers, captured once per distinct ``nb`` (at most one per
  power-of-two bucket); the carry holds global state only, and the
  updated per-client rows go out through row ``i`` of the outputs, which
  the host scatters into the stores at the chunk boundary.

Streaming and stacked plans over one source draw the same numbers from
the same generator (eagerly or in a replay), so they select alike.

On the CPU the same round runs eagerly (the parity tests), collectives
and all.  On the card a round that fails to capture or replay raises:
nothing re-runs it eagerly.  Kernel launches are counted when a wrapper
is called, so the driver takes a capture's launches off
``build.launch_counts`` and adds them back at every replay.
"""
from __future__ import annotations

import time
import warnings
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import codecs
from repro_torch.core import pytree as pt
from repro_torch.core import server, sharding
from repro_torch.core.client import make_batched_grad_fn, make_batched_solver
from repro_torch.core.scenarios import (availability_mask_staged,
                                        env_channels, is_trivial,
                                        realize_env_staged, scenario_spec,
                                        staged_availability, staged_work)
from repro_torch.core.strategies import (AlgorithmSpec, ControlCtx, CorrCtx,
                                         algorithm_spec, make_server_opt,
                                         runtime_state_fields)
from repro_torch.core.client_state import SparseClientState
from repro_torch.data.batching import (stack_device_batches,
                                       stack_eval_batches)
from repro_torch.data.shard_source import resolve_streaming
from repro_torch.device import resolve_device
from repro_torch.kernels import build, flatpack
from repro_torch.kernels.codec import codec_aggregate, codec_aggregate_partial

F32 = torch.float32


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
            num, cnt = sharding.tree_psum(
                (codec_aggregate_partial(vals, scales, mask), mask.sum()),
                self.mesh)
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
                delta_sum = sharding.tree_psum(pt.tmap(
                    lambda n, o: (n - o).sum(dim=0), c_new,
                    aux["controls"]), mesh)
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


# -- the scanned multi-round driver -----------------------------------------

def _make_stacked_eval(loss_fn: Callable, eval_batches, eval_valid,
                       eval_weights, mesh=None) -> Callable:
    """The global loss over the all-device stacked eval tensors as one
    tensor expression: per device the mean batch loss over its *valid*
    batches, then the p_k-weighted mean over devices -- what
    ``FederatedTrainer.global_loss`` computes, with no Python branch on
    data, so a CUDA graph captures it.

    ``mesh``: where the rank count divides the eval rows, each rank
    keeps its rows only, and the weighted sum of its rows is summed over
    the ranks (``tree_psum``) before the division by the whole weight
    sum; otherwise every rank evaluates every row."""
    per_batch = vmap(vmap(loss_fn, in_dims=(None, 0)), in_dims=(None, 0))
    rows = eval_weights.shape[0]
    if mesh is None or rows % sharding.num_shards(mesh) != 0:
        mesh = None
    else:
        wsum = torch.clamp(eval_weights.sum(), min=1e-12)
        lo, hi = sharding.shard_rows(rows, mesh)
        eval_batches, eval_valid, eval_weights = pt.tmap(
            lambda x: x[lo:hi].clone(),
            (eval_batches, eval_valid, eval_weights))

    def eval_loss(p):
        losses = per_batch(p, eval_batches)                    # (N, nb)
        dev = ((losses * eval_valid).sum(dim=1)
               / torch.clamp(eval_valid.sum(dim=1), min=1.0))
        if mesh is None:
            return ((eval_weights * dev).sum()
                    / torch.clamp(eval_weights.sum(), min=1e-12))
        return sharding.tree_psum((eval_weights * dev).sum(), mesh) / wsum

    return eval_loss


def scan_env_uniforms(gen: torch.Generator, channels: Tuple[str, ...],
                      n: int, t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The scanned driver's environment draw for one round: one ``(n,)``
    float32 uniform per channel, in ``channels``' order, from ``gen``
    (inside the captured round on the card).  ``t`` is the round index,
    a ``(1,)`` int64 tensor on the driver's device, which this draw does
    not read: the driver looks the function up here at every round, so
    a test can put a table of other draws indexed by ``t`` in its
    place."""
    return {c: torch.rand(n, generator=gen, device=gen.device)
            for c in channels}


def new_history() -> Dict[str, List[float]]:
    """The run-history dict both drivers fill (one schema)."""
    return {"round": [], "comm_rounds": [], "loss": [], "intended_k": [],
            "effective_k": [], "dropped": [], "bytes_up": [],
            "bytes_down": []}


def _assign(dst, src) -> None:
    """Copy the tree ``src`` into the buffers of the tree ``dst``."""
    for d, s in zip(pt.leaves(dst), pt.leaves(src)):
        d.copy_(s)


class _Program:
    """One captured program: its graph segments
    (:class:`~repro_torch.core.sharding.SegmentedGraph`, one segment
    without the client mesh) and the kernel launches each replay makes
    (counted at capture, added back at every replay)."""

    def __init__(self, graph: sharding.SegmentedGraph,
                 launches: Dict[str, int]):
        self.graph, self.launches = graph, launches

    def replay(self) -> None:
        self.graph.replay()
        for k, v in self.launches.items():
            build.launch_counts[k] += v


class ScannedDriver:
    """The scanned multi-round driver (see the module docstring).

    One instance per ``(loss_fn, dataset, cfg)``: it stacks every
    device's train and eval batches once (on the client mesh, where D
    divides N, its rows of them) and exposes :meth:`run` with
    ``FederatedTrainer.run``'s ``(history, final_params)`` contract.  On
    the card it captures, at first use, the round with on-card sampling,
    the round that reads injected selections, and the eval, and keeps
    them for later runs of the same shapes.
    """

    def __init__(self, loss_fn: Callable, dataset, cfg,
                 engine: Optional[RoundEngine] = None, device=None):
        """``engine`` shares a trainer's :class:`RoundEngine` (by default
        one is built from ``cfg``) and with it the client mesh;
        ``device`` is the dataset's by default.  Raises for a
        control-variate spec with replacement (duplicated selections need
        sequential control updates) and, on the mesh, for a selection
        size (every device, for full participation) that does not split
        evenly over the ranks."""
        self.spec = algorithm_spec(cfg.algorithm)
        if self.spec.control_update is not None and \
                cfg.sample_with_replacement:
            raise ValueError(
                f"{cfg.algorithm} + sample_with_replacement requires "
                f"sequential per-duplicate control updates; use the "
                f"python driver")
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(
            getattr(dataset, "device", None) if device is None else device)
        self.num_devices = n = dataset.num_devices
        self.engine = engine if engine is not None else RoundEngine(
            loss_fn, cfg, spec=self.spec, num_devices=n)
        #: the client mesh (core/sharding.py), the engine's
        self.mesh = mesh = self.engine.mesh
        self.k_sel = (cfg.devices_per_round if cfg.sample_with_replacement
                      else min(cfg.devices_per_round, n))
        if mesh is not None:
            if self.spec.num_selections == 0:
                sharding.check_divisible(
                    n, mesh, "num_devices (full-participation spec)")
            else:
                sharding.check_divisible(self.k_sel, mesh,
                                         "devices_per_round")
        self.scn = scenario_spec(cfg.scenario)
        self.scn_trivial = is_trivial(self.scn)
        self._env_channels = env_channels(self.scn)
        self._codec = self.engine._codec
        self._codec_trivial = self.engine._codec_trivial
        #: the streaming plan (module docstring): only the chunk's
        #: cohorts are staged.  Full-participation specs touch every
        #: client every round, so they take the stacked plan on either
        #: kind of dataset
        self.streaming = (resolve_streaming(cfg.client_source, dataset)
                          and self.spec.num_selections > 0)
        #: this rank's rows ``[lo, hi)`` of a cohort (all of them without
        #: a mesh)
        self._krows = sharding.shard_rows(
            n if self.spec.num_selections == 0 else self.k_sel, mesh)
        #: on the mesh: whether each rank keeps only its N/D clients'
        #: all-device stacks (train and eval rows, controls, error
        #: feedback) -- where D divides N; otherwise they are replicated.
        #: Streaming builds no all-device stacks and records 1.0, as the
        #: reference does
        self._layout_sharded = mesh is not None and (
            self.streaming or n % sharding.num_shards(mesh) == 0)
        if self.streaming:
            self.batches_all = self.valid_all = None
        else:
            ids, nb = np.arange(n), None
            if mesh is not None and not self._layout_sharded:
                warnings.warn(
                    f"mesh layout fallback: num_devices={n} is not "
                    f"divisible by mesh_devices={mesh.world}; the "
                    f"all-client stacks are replicated on every rank "
                    f"(cohorts still shard); the run history records "
                    f"sharded=0.0", stacklevel=2)
            elif mesh is not None:
                # the rank's rows, padded to the dataset-wide batch count
                nb = max(dataset.num_batches(k) for k in ids)
                lo, hi = sharding.shard_rows(n, mesh)
                ids = ids[lo:hi]
            self.batches_all, self.valid_all = stack_device_batches(
                dataset, ids, nb=nb)
        self._eval_loss = _make_stacked_eval(
            loss_fn, *stack_eval_batches(dataset),
            mesh=mesh if self._layout_sharded else None)
        w = dataset.weights
        self.probs = (torch.tensor(w, dtype=F32, device=self.device)
                      if cfg.weighted_sampling and w is not None else None)
        self.k_intended = (n if self.spec.num_selections == 0
                           else self.k_sel)
        self.comm_per_round = self.spec.comm_per_round
        self._state_fields = runtime_state_fields(self.spec, cfg)
        # the reference's stacked chunk evaluates the work fractions
        # compiled; its streaming schedule realizes them eagerly
        frac = staged_work(self.scn, cfg, n, compiled=not self.streaming)
        self._frac = None if frac is None else frac.to(self.device)
        self._all = (torch.arange(n, device=self.device)
                     if self.spec.num_selections == 0 else None)
        self.gen = torch.Generator(device=self.device)
        #: programs captured on the card, by name ("sampled",
        #: "injected", "eval"), and the host seconds each capture took
        #: (its warm-up included)
        self._programs: Dict[str, _Program] = {}
        self.capture_s: Dict[str, float] = {}
        self._layout = None
        self._carry: Dict[str, Any] = {}
        self._xs: Dict[str, torch.Tensor] = {}
        self._ys: Dict[str, torch.Tensor] = {}
        self._ctr = torch.zeros(2, dtype=torch.long, device=self.device)
        #: streaming: the staged cohort buffers of each padded batch
        #: count (one captured round each) and the sparse stores of the
        #: per-client state, keyed by client id
        self._sbufs: Dict[int, Dict[str, Any]] = {}
        self.controls_store: Optional[SparseClientState] = None
        self.ef_store: Optional[SparseClientState] = None

    # -- the round and the eval -------------------------------------------

    def _mine(self, x):
        """This rank's rows of a global ``(K, ...)`` cohort tensor."""
        lo, hi = self._krows
        return x if self.mesh is None else x[lo:hi]

    def _pick(self, requests) -> List[Any]:
        """This rank's rows of ``x[sel]`` for every ``(tree, sel)`` of
        ``requests``, ``tree`` all-device stacks: an index on one process
        or a replicated layout, one exchange
        (``sharding.gather_selected``) for all of them on a sharded
        one."""
        if self._layout_sharded:
            return sharding.gather_selected(requests, self.mesh)
        return [pt.tmap(lambda x: x.index_select(0, self._mine(sel)), tree)
                for tree, sel in requests]

    def _put(self, trees, sel, rows) -> None:
        """Write a cohort's updated rows (this rank's, ``rows``) back into
        the all-device stacks ``trees`` at ``sel``."""
        if self._layout_sharded:
            sharding.scatter_selected(trees, sel, rows, self.mesh)
            return
        pt.tmap(lambda d, x: d.index_copy_(0, sel, x), trees,
                sharding.gather_rows(rows, self.mesh))

    def _round(self, sampled: bool) -> None:
        """One round on the carried state, in place: the engine's generic
        round body plus on-card selection, gather/scatter and the
        environment.  Reads row ``i = ctr[0]`` of the chunk's staged
        inputs and advances the counter; no host sync.  On the mesh the
        rank takes its rows of the cohort (:meth:`_pick`) and writes them
        back (:meth:`_put`)."""
        cfg, spec, eng = self.cfg, self.spec, self.engine
        c, xs, n = self._carry, self._xs, self.num_devices
        i, t = self._ctr[0:1], self._ctr[1:2]

        def row(buf):
            return buf.index_select(0, i)[0]

        full = spec.num_selections == 0
        s1 = s2 = None
        if not full and sampled:
            s1 = server.sample_devices_onchip(
                self.gen, n, self.k_sel, p=self.probs,
                replace=cfg.sample_with_replacement)
            s2 = (server.sample_devices_onchip(
                self.gen, n, self.k_sel, p=self.probs,
                replace=cfg.sample_with_replacement)
                if spec.num_selections == 2 else s1)
        elif not full:
            sel = row(xs["sel"])
            s1, s2 = sel[0], sel[1]
        # as the python driver maps phases: the first selection feeds the
        # gradient gather, the solve selection is the second only for
        # two-selection specs (and every device for full participation)
        sel_solve = s1 if spec.num_selections < 2 else s2
        decay = row(xs["decay"]) if spec.decay is not None else 1.0
        has_controls = "controls" in self._state_fields
        aux_fields = [f for f in self._state_fields if f != "controls"]
        aux = {f: c[f] for f in aux_fields}
        codec = self._codec
        ef = not self._codec_trivial and codec.error_feedback
        # the per-client state the round reads: SCAFFOLD's controls and
        # the codec's error feedback
        state = {}
        if has_controls:
            state["controls"] = c["controls"]
        if ef:
            state["ef"] = c["ef"]
        if full:
            # (on the mesh the all-device stacks hold the rank's rows)
            b, v, phase_a, rows = (self.batches_all, self.valid_all, None,
                                   state)
        else:
            two = spec.grad_source == "fresh" and spec.num_selections == 2
            picked = self._pick(
                [((self.batches_all, self.valid_all, state), sel_solve)]
                + ([((self.batches_all, self.valid_all), s1)] if two
                   else []))
            b, v, rows = picked[0]
            phase_a = tuple(picked[1]) if two else None
        if has_controls:
            aux["c_server"] = c["c_server"]
            aux["controls"] = rows["controls"]
        if not self._codec_trivial:
            if codec.uses_rng:
                aux["codec_draws"] = codecs.CodecDraws(
                    row(xs["signs"]), self._mine(row(xs["u"])),
                    row(xs["noise"]))
            if ef:
                aux["ef"] = rows["ef"]
        stats = None
        if self.scn_trivial:
            params, new = eng.round(c["params"], aux, phase_a, b, v, decay)
        else:
            # one per-DEVICE (n,) uniform per channel (duplicates share an
            # outcome); full-participation specs solve on every device
            scn = self.scn
            sel_env = self._all if full else sel_solve
            uniforms = scan_env_uniforms(self.gen, self._env_channels, n, t)
            p_t = row(xs["avail"]) if scn.availability is not None else None
            env = realize_env_staged(scn, cfg, sel_env, p_t, self._frac,
                                     uniforms)
            active_a = None
            if spec.grad_source == "fresh":
                # availability gates the gather too, with the same draws
                sel_a = sel_env if phase_a is None else s1
                active_a = self._mine(availability_mask_staged(
                    scn, sel_a, p_t, uniforms))
            params, new, stats = eng.round_env(
                c["params"], aux, phase_a, b, v, decay,
                self._mine(env.active), self._mine(env.work), active_a)
        for f in aux_fields:
            _assign(c[f], new[f])
        if has_controls:
            _assign(c["c_server"], new["c_server"])
        updated = {f: new[f] for f in state}
        if updated and full:
            _assign(state, updated)
        elif updated:
            self._put(state, sel_solve, updated)
        _assign(c["params"], params)
        if stats is not None:
            self._ys["effective_k"].index_copy_(
                0, i, stats["effective_k"].reshape(1).to(F32))
            self._ys["effective_a"].index_copy_(
                0, i, stats["effective_a"].reshape(1).to(F32))
        self._ctr.add_(1)

    def _eval(self) -> None:
        """The global loss at the carried params into the loss slot of
        the round just run (``ctr[0] - 1``)."""
        loss = self._eval_loss(self._carry["params"])
        self._ys["loss"].index_copy_(0, self._ctr[0:1] - 1,
                                     loss.reshape(1).to(F32))

    def _stream_round(self, nb: int) -> None:
        """One streaming round on the carried global state, in place:
        the engine's round body on row ``i = ctr[0]`` of the staged
        cohort buffers of batch count ``nb`` (batches, state rows, the
        realized environment); the updated per-client rows go to row
        ``i`` of the outputs, for the host to scatter back.  No
        selection, no gather, no draw: the schedule pass made them."""
        cfg, spec, eng = self.cfg, self.spec, self.engine
        c, xs, sb, ys = self._carry, self._xs, self._sbufs[nb], self._ys
        i = self._ctr[0:1]

        def row(buf):
            return buf.index_select(0, i)[0]

        b, v = pt.tmap(row, sb["b"]), row(sb["v"])
        phase_a = ((pt.tmap(row, sb["ba"]), row(sb["va"]))
                   if "ba" in sb else None)
        decay = row(xs["decay"]) if spec.decay is not None else 1.0
        aux_fields = [f for f in self._state_fields if f != "controls"]
        aux = {f: c[f] for f in aux_fields}
        has_controls = "controls" in self._state_fields
        if has_controls:
            aux["c_server"] = c["c_server"]
            aux["controls"] = pt.tmap(row, sb["controls"])
        codec = self._codec
        if not self._codec_trivial:
            if codec.uses_rng:
                aux["codec_draws"] = codecs.CodecDraws(
                    row(xs["signs"]), self._mine(row(xs["u"])),
                    row(xs["noise"]))
            if codec.error_feedback:
                aux["ef"] = row(sb["ef"])
        stats = None
        if self.scn_trivial:
            params, new = eng.round(c["params"], aux, phase_a, b, v, decay)
        else:
            params, new, stats = eng.round_env(
                c["params"], aux, phase_a, b, v, decay, row(sb["active"]),
                row(sb["work"]),
                row(sb["active_a"]) if "active_a" in sb else None)
        for f in aux_fields:
            _assign(c[f], new[f])
        if has_controls:
            _assign(c["c_server"], new["c_server"])
            pt.tmap(lambda d, x: d.index_copy_(0, i, x.unsqueeze(0)),
                    ys["controls"], new["controls"])
        if not self._codec_trivial and codec.error_feedback:
            ys["ef"].index_copy_(0, i, new["ef"].unsqueeze(0))
        _assign(c["params"], params)
        if stats is not None:
            ys["effective_k"].index_copy_(
                0, i, stats["effective_k"].reshape(1).to(F32))
            ys["effective_a"].index_copy_(
                0, i, stats["effective_a"].reshape(1).to(F32))
        self._ctr.add_(1)

    # -- capture -----------------------------------------------------------

    def _state_tensors(self) -> List[torch.Tensor]:
        return pt.leaves(self._carry) + pt.leaves(self._ys) + [self._ctr]

    def _capture(self, name: str, fn: Callable) -> _Program:
        """Capture ``fn`` as a CUDA graph (segments split at its
        collectives on the mesh).  It first runs once on a side
        stream (libraries, handles and caches initialise outside the
        capture), from a snapshot of the carried state and the generator
        that is restored afterwards; that warm-up's launches ran and stay
        counted.  The capture's own launches do not run, so they come off
        the counters and return at every replay."""
        t0 = time.perf_counter()
        state = self._state_tensors()
        snap = [x.clone() for x in state]
        gen_state = self.gen.get_state()
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        for x, s in zip(state, snap):
            x.copy_(s)
        self.gen.set_state(gen_state)
        del snap
        before = dict(build.launch_counts)
        graph = sharding.SegmentedGraph(self.mesh, (self.gen,))
        with graph.capture(self.device):
            fn()
        launches = {k: build.launch_counts[k] - before[k]
                    for k in before if build.launch_counts[k] != before[k]}
        for k, v in launches.items():
            build.launch_counts[k] -= v
        torch.cuda.synchronize(self.device)
        self.capture_s[name] = time.perf_counter() - t0
        return _Program(graph, launches)

    def _step(self, name: str, fn: Callable) -> None:
        """Run ``fn`` once: eagerly on the CPU, as a replay of its
        captured program on the card (captured at first use)."""
        if self.device.type != "cuda":
            fn()
            return
        prog = self._programs.get(name)
        if prog is None:
            prog = self._programs[name] = self._capture(name, fn)
        prog.replay()

    # -- host-side chunked run --------------------------------------------

    def _emit_rounds(self, hist, off: int, hi: int, losses, eff, eff_a,
                     eval_mask, n_elems: int, verbose: bool) -> None:
        """Append one chunk's realized telemetry and eval points to the
        run history."""
        cfg = self.cfg
        intended = self.k_intended
        for i, t in enumerate(range(off, hi)):
            if self.mesh is not None:
                hist["sharded"].append(1.0 if self._layout_sharded else 0.0)
            hist["intended_k"].append(float(intended))
            hist["effective_k"].append(float(eff[i]))
            hist["dropped"].append(float(intended - eff[i]))
            up, down = codecs.round_bytes(
                self.spec, self._codec, cfg, n_elems, float(eff_a[i]),
                float(eff[i]))
            hist["bytes_up"].append(up)
            hist["bytes_down"].append(down)
            if not eval_mask[t]:
                continue
            hist["round"].append(t + 1)
            hist["comm_rounds"].append((t + 1) * self.comm_per_round)
            hist["loss"].append(float(losses[i]))
            if verbose:
                print(f"[{cfg.algorithm}] round {t + 1:4d} "
                      f"comm {(t + 1) * self.comm_per_round:4d} "
                      f"loss {float(losses[i]):.4f}")

    def _init_carry(self, params) -> Dict[str, Any]:
        """The carried state: params plus the spec's persistent state in
        the stacked layout (controls and error feedback as ``(N, ...)``
        stacks), as fresh tensors on the driver's device.  Streaming
        carries the global state only; the per-client state starts in
        fresh sparse stores (``controls_store``, ``ef_store``)."""
        n, cfg = self.num_devices, self.cfg
        if self.streaming:
            n = 0                   # no (N, ...) stacks in the carry
        elif self._layout_sharded:
            n //= self.mesh.world   # the rank's rows of them
        params = pt.tmap(lambda x: x.detach().to(self.device, copy=True),
                         params)
        carry: Dict[str, Any] = {"params": params}
        for f in self._state_fields:
            if f == "g_prev":
                carry["g_prev"] = pt.zeros_like(params)
            elif f == "center":
                carry["center"] = pt.tmap(torch.clone, params)
            elif f == "controls":
                carry["c_server"] = pt.zeros_like(params)
                if self.streaming:
                    self.controls_store = SparseClientState(
                        self.num_devices, pt.zeros_like(params))
                else:
                    carry["controls"] = pt.tmap(
                        lambda x: x.new_zeros((n,) + x.shape), params)
            elif f == "opt":
                carry["opt"] = make_server_opt(self.spec, cfg).init(params)
        if self._codec.error_feedback:
            if self.streaming:
                self.ef_store = codecs.init_ef(
                    self._codec, flatpack.flat_spec(params),
                    self.num_devices, self.device)
            else:
                rows = flatpack.flat_spec(params).rows
                carry["ef"] = torch.zeros((n, rows, flatpack.LANES),
                                          dtype=F32, device=self.device)
        return carry

    def _prepare(self, params, capacity: int) -> None:
        """Load the carry for a run from ``params``, in place when the
        buffers (and so the captured programs that read them) fit: same
        tree, shapes and dtypes, and staged inputs for ``capacity``
        rounds at least.  Otherwise allocate anew and drop the
        programs."""
        fresh = self._init_carry(params)
        layout = [(tuple(x.shape), x.dtype) for x in pt.leaves(fresh)]
        layout.append(repr(pt.flatten(fresh)[1]))
        if self._layout is not None and self._layout[0] == layout \
                and self._layout[1] >= capacity:
            _assign(self._carry, fresh)
            return
        self._programs.clear()
        self._sbufs = {}
        self._layout = (layout, capacity)
        self._carry = fresh
        dev, n, r = self.device, self.num_devices, capacity
        rows = flatpack.flat_spec(fresh["params"]).rows
        lanes = flatpack.LANES
        self._ys = {k: torch.zeros(r, dtype=F32, device=dev)
                    for k in ("loss", "effective_k", "effective_a")}
        xs = {}
        if self.streaming:
            # the rounds' updated per-client rows (the rank's, on the
            # mesh), scattered by the host
            k = self._krows[1] - self._krows[0]
            if "controls" in self._state_fields:
                self._ys["controls"] = pt.tmap(
                    lambda x: x.new_zeros((r, k) + x.shape),
                    fresh["params"])
            if self._codec.error_feedback:
                self._ys["ef"] = torch.zeros((r, k, rows, lanes),
                                             dtype=F32, device=dev)
        else:
            xs["sel"] = torch.zeros((r, 2, self.k_sel), dtype=torch.long,
                                    device=dev)
            if self.scn.availability is not None:
                xs["avail"] = torch.zeros((r, n), dtype=F32, device=dev)
        if self.spec.decay is not None:
            xs["decay"] = torch.zeros(r, dtype=F32, device=dev)
        if self._codec.uses_rng:
            xs["signs"] = torch.zeros((r, lanes), dtype=F32, device=dev)
            xs["u"] = torch.zeros((r, self.k_intended, rows, lanes),
                                  dtype=F32, device=dev)
            xs["noise"] = torch.zeros((r, rows, lanes), dtype=F32,
                                      device=dev)
        self._xs = xs

    def _stage(self, off: int, hi: int, sel, rows: int) -> None:
        """Compute the round-indexed inputs of rounds ``off .. hi-1`` on
        the host and copy them into the staged buffers; point the
        counter at the chunk's first row and round."""
        cfg, spec, xs = self.cfg, self.spec, self._xs
        r = hi - off
        if sel is not None and spec.num_selections > 0:
            xs["sel"][:r].copy_(torch.from_numpy(sel[off:hi]))
        if spec.decay is not None:
            xs["decay"][:r].copy_(torch.tensor(
                [spec.decay(cfg, t) for t in range(off, hi)], dtype=F32))
        if "avail" in xs:
            # the round index as the reference's scan body sees it:
            # float32
            xs["avail"][:r].copy_(torch.stack([
                staged_availability(self.scn, cfg, self.num_devices,
                                    torch.tensor(t, dtype=F32))
                for t in range(off, hi)]))
        if self._codec.uses_rng:
            # the python driver's draws for the same round (the
            # reference's scan and host loop share round_key(cfg, t))
            draws = [codecs.round_draws(self._codec, cfg, t,
                                        self.k_intended, rows, "cpu")
                     for t in range(off, hi)]
            for j, name in enumerate(("signs", "u", "noise")):
                xs[name][:r].copy_(torch.stack([d[j] for d in draws]))
        self._ctr.copy_(torch.tensor([0, off]))
        self._ys["loss"].fill_(float("nan"))

    # -- the streaming plan -------------------------------------------------

    def _schedule(self, off: int, hi: int, sel,
                  stateful: bool) -> List[Dict[str, np.ndarray]]:
        """The streaming chunk's schedule pass: rounds ``off .. hi-1``'s
        draws, eagerly on the driver's generator in the order the
        stacked round makes them (``s1``, ``s2``, the environment's
        uniforms), the environment realized on the driver's device, and
        ONE host sync for the chunk's selections and masks.  A stateful
        spec's chunk ends before the first round whose cohort repeats a
        client of the chunk (its state rows would be stale); the
        generator then goes back to that round's state, so the next
        chunk redraws it and no draw is lost."""
        cfg, spec, dev = self.cfg, self.spec, self.device
        n, two = self.num_devices, spec.num_selections == 2
        fresh = spec.grad_source == "fresh"
        states, parts = [], []
        for t in range(off, hi):
            states.append(self.gen.get_state())
            if sel is None:
                s1 = server.sample_devices_onchip(
                    self.gen, n, self.k_sel, p=self.probs,
                    replace=cfg.sample_with_replacement)
                s2 = (server.sample_devices_onchip(
                    self.gen, n, self.k_sel, p=self.probs,
                    replace=cfg.sample_with_replacement) if two else s1)
            else:
                s1, s2 = (torch.from_numpy(sel[t, 0]).to(dev),
                          torch.from_numpy(sel[t, 1]).to(dev))
            sel_solve = s2 if two else s1
            row = [s1.double(), sel_solve.double()]
            if not self.scn_trivial:
                scn = self.scn
                uniforms = scan_env_uniforms(
                    self.gen, self._env_channels, n,
                    torch.tensor([t], device=dev))
                p_t = staged_availability(scn, cfg, n,
                                          torch.tensor(t, dtype=F32))
                p_t = None if p_t is None else p_t.to(dev)
                env = realize_env_staged(scn, cfg, sel_solve, p_t,
                                         self._frac, uniforms)
                row += [env.active.double(), env.work.double()]
                if fresh:
                    row.append(availability_mask_staged(
                        scn, s1 if two else sel_solve, p_t,
                        uniforms).double())
            parts.append(torch.stack(row))
        host = torch.stack(parts).cpu().numpy()      # the one sync
        names = ["s1", "sel_solve", "active", "work", "active_a"]
        rows: List[Dict[str, np.ndarray]] = []
        seen: set = set()
        for j, t in enumerate(range(off, hi)):
            r = {names[q]: host[j, q] for q in range(host.shape[1])}
            r["s1"] = r["s1"].astype(np.int64)
            r["sel_solve"] = r["sel_solve"].astype(np.int64)
            for q in ("active", "work", "active_a"):
                if q in r:
                    r[q] = r[q].astype(np.float32)
            ids = set(r["sel_solve"].tolist())
            if stateful and rows and not seen.isdisjoint(ids):
                self.gen.set_state(states[j])
                break
            seen |= ids
            rows.append(r)
        return rows

    def _stream_stage(self, off: int, rows: List[Dict[str, np.ndarray]],
                      wire_rows: int) -> int:
        """Stage the chunk's cohorts, the sparse stores' rows and the
        realized environment into the staged buffers of the chunk's
        batch count ``nb`` (its largest client's), and the round-indexed
        inputs as the stacked plan does; returns ``nb``.  Every client
        is cycled out to ``nb`` with its steps past its own masked (the
        reference's ``_pad_cohort``), so the trajectory is the unpadded
        one."""
        spec = self.spec
        two = spec.grad_source == "fresh" and spec.num_selections == 2
        cohorts = [r["sel_solve"] for r in rows]
        if two:
            cohorts += [r["s1"] for r in rows]
        # the batch count from the clients' sizes: a rank of the mesh
        # generates only its rows of each cohort
        lo, hi = self._krows
        nb = max(self.dataset.num_batches(k)
                 for c in cohorts for k in c)
        stacks = [stack_device_batches(self.dataset, c[lo:hi], nb=nb)
                  for c in cohorts]
        sb = self._sbufs.get(nb)
        if sb is None:
            sb = self._sbufs[nb] = self._stream_buffers(nb, stacks[0][0],
                                                        two)
        phases = [("", 0)] + ([("a", len(rows))] if two else [])
        for j, r in enumerate(rows):
            for q, first in phases:
                b, v = stacks[first + j]
                pt.tmap(lambda d, x: d[j].copy_(x), sb["b" + q], b)
                sb["v" + q][j].copy_(v)
            mine = r["sel_solve"][lo:hi]
            if self.controls_store is not None:
                pt.tmap(lambda d, x: d[j].copy_(x), sb["controls"],
                        self.controls_store.gather(mine))
            if self.ef_store is not None:
                sb["ef"][j].copy_(self.ef_store.gather(mine))
            for q in ("active", "work", "active_a"):
                if q in sb:
                    sb[q][j].copy_(torch.from_numpy(r[q][lo:hi]))
        self._stage(off, off + len(rows), None, wire_rows)
        return nb

    def _stream_buffers(self, nb: int, example, two: bool
                        ) -> Dict[str, Any]:
        """The staged inputs of batch count ``nb`` for a chunk's rounds:
        fixed tensors the captured streaming round of ``nb`` reads."""
        r, k = self._layout[1], self._krows[1] - self._krows[0]
        dev, spec = self.device, self.spec

        def zeros(*shape):
            return torch.zeros(shape, dtype=F32, device=dev)

        def cohort(x):
            return x.new_zeros((r, k, nb) + tuple(x.shape[2:]))

        sb: Dict[str, Any] = {"b": pt.tmap(cohort, example),
                              "v": zeros(r, k, nb)}
        if two:
            sb["ba"], sb["va"] = pt.tmap(cohort, example), zeros(r, k, nb)
        params = self._carry["params"]
        if self.controls_store is not None:
            sb["controls"] = pt.tmap(lambda x: x.new_zeros((r, k) + x.shape),
                                     params)
        if self.ef_store is not None:
            sb["ef"] = zeros(r, k, flatpack.flat_spec(params).rows,
                             flatpack.LANES)
        if not self.scn_trivial:
            sb["active"], sb["work"] = zeros(r, k), zeros(r, k)
            if spec.grad_source == "fresh":
                sb["active_a"] = zeros(r, k)
        return sb

    @property
    def stream_captures(self) -> int:
        """Captured streaming rounds: one per padded batch count seen."""
        return sum(1 for k in self._programs if k.startswith("stream:"))

    def _stream_scatter(self, sched) -> None:
        """The chunk's updated per-client rows back into the sparse
        stores; on the mesh every rank's rows reach every rank first
        (one ``sharding.gather_rows``), so each rank's stores hold the
        whole cohorts."""
        r = len(sched)
        outs = {}
        if self.controls_store is not None:
            outs["controls"] = self._ys["controls"]
        if self.ef_store is not None:
            outs["ef"] = self._ys["ef"]
        if self.mesh is not None:
            # (rounds, K/D, ...) -> (K, rounds, ...): gather the cohort axis
            outs = pt.tmap(lambda x: x.transpose(0, 1), sharding.gather_rows(
                pt.tmap(lambda x: x[:r].transpose(0, 1).contiguous(), outs),
                self.mesh))
        for j, row in enumerate(sched):
            if self.controls_store is not None:
                self.controls_store.scatter(
                    row["sel_solve"],
                    pt.tmap(lambda x: x[j].clone(), outs["controls"]))
            if self.ef_store is not None:
                self.ef_store.scatter(row["sel_solve"],
                                      outs["ef"][j].clone())

    def run(self, params, num_rounds: int, eval_every: int = 1,
            verbose: bool = False, checkpoint_dir: Optional[str] = None,
            selections=None) -> Tuple[Dict[str, List[float]], Any]:
        """Chunked run; the same contract as ``FederatedTrainer.run``.

        ``selections``: optional int array ``(num_rounds, 2, K)`` (or
        ``(num_rounds, K)``, broadcast to both phases) in place of the
        on-card sampler -- to make the drivers' sampling comparable.
        The generator is seeded from ``cfg.seed`` at every run, so a run
        repeats bit for bit.
        """
        cfg = self.cfg
        sel = None
        if selections is not None:
            sel = np.asarray(selections).astype(np.int64)
            if sel.ndim == 2:
                sel = np.stack([sel, sel], axis=1)
            if sel.shape[0] < num_rounds:
                raise ValueError(
                    f"selections covers {sel.shape[0]} rounds "
                    f"< num_rounds={num_rounds}")
        chunk_rounds = cfg.chunk_rounds if cfg.chunk_rounds > 0 \
            else num_rounds
        t_all = np.arange(num_rounds)
        eval_mask = (t_all % eval_every == 0) | (t_all == num_rounds - 1)
        hist = new_history()
        if self.mesh is not None:
            # layout telemetry, a value a round (the reference's)
            hist["sharded"] = []
        intended = self.k_intended
        n_elems = sum(x.numel() for x in pt.leaves(params))
        gather_full = (float(intended)
                       if self.spec.grad_source == "fresh" else 0.0)
        self._prepare(params, min(chunk_rounds, num_rounds))
        rows = flatpack.flat_spec(self._carry["params"]).rows
        self.gen.manual_seed(cfg.seed)
        stateful = (self.controls_store is not None
                    or self.ef_store is not None)
        off = 0
        while off < num_rounds:
            hi = min(off + chunk_rounds, num_rounds)
            if self.streaming:
                sched = self._schedule(off, hi, sel, stateful)
                hi = off + len(sched)
                nb = self._stream_stage(off, sched, rows)
                name, body = f"stream:{nb}", partial(self._stream_round, nb)
            else:
                self._stage(off, hi, sel, rows)
                name = "sampled" if sel is None else "injected"
                body = partial(self._round, sel is None)
            for t in range(off, hi):
                self._step(name, body)
                if eval_mask[t]:
                    self._step("eval", self._eval)
            # chunk boundary: the only host round-trip; the streaming
            # plan's state rows go back into the sparse stores
            ys = {k: self._ys[k][:hi - off].cpu().numpy()
                  for k in ("loss", "effective_k", "effective_a")}
            if self.streaming and stateful:
                self._stream_scatter(sched)
            if self.scn_trivial:
                eff = np.full(hi - off, intended, dtype=np.float64)
                eff_a = np.full(hi - off, gather_full, dtype=np.float64)
            else:
                eff = ys["effective_k"].astype(np.float64)
                eff_a = ys["effective_a"].astype(np.float64)
            self._emit_rounds(hist, off, hi, ys["loss"], eff, eff_a,
                              eval_mask, n_elems, verbose)
            if checkpoint_dir is not None:
                from repro_torch.checkpoint.store import save_checkpoint
                save_checkpoint(checkpoint_dir,
                                {"params": self._carry["params"],
                                 "round": hi}, step=hi)
            off = hi
        return hist, pt.tmap(torch.clone, self._carry["params"])


def make_scanned_run(loss_fn: Callable, dataset, cfg,
                     engine: Optional[RoundEngine] = None,
                     device=None) -> ScannedDriver:
    """Factory for the scanned multi-round driver: a
    :class:`ScannedDriver` whose ``run(params, num_rounds, ...)`` runs
    rounds as replays of captured programs with on-card sampling and
    in-driver eval.  ``engine`` shares a trainer's :class:`RoundEngine`."""
    return ScannedDriver(loss_fn, dataset, cfg, engine=engine,
                         device=device)
