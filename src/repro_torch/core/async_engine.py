"""FedBuff-style asynchronous buffered round driver (the fourth driver).

Counterpart of ``repro/core/async_engine.py``.  The synchronous drivers wait
for every selected client, then step.  :class:`BufferedDriver`
(``FederatedConfig.round_driver="buffered"``) has no round barrier and
reads the scenario's latency process as an event queue (Nguyen et al.
2022, FedBuff):

- ``K = devices_per_round`` clients are in flight at any moment, each
  solving the spec's local subproblem from the server params as they
  were at its launch (a possibly stale anchor);
- a finished client's update ``anchor - w_local`` is staged into a
  double-buffered ``(M, ...)`` area on the trainer's device; when
  ``M = buffer_size`` updates are staged the server commits: the
  buffer's :func:`~repro_torch.core.server.staleness_weight`-ed mean
  (:func:`~repro_torch.core.server.aggregate_buffered`) goes through
  :func:`~repro_torch.core.server.server_step`, and the freed slots
  relaunch from the new params;
- the scenario drives the simulation through
  :func:`~repro_torch.core.scenarios.realize_event_env`: the latency
  draw is the arrival delay, availability and dropout mean the update
  is never delivered, and ``max_staleness`` plays the deadline's part.

The driver interprets any registered
:class:`~repro_torch.core.strategies.AlgorithmSpec` as the reference's
does: FedDANE's gradient gather runs at cohort launch against the launch
anchor (so ``g_t`` is as stale as the anchor); pipelined FedDANE reads
the ``g_prev`` of launch time, refreshed at each commit by the weighted
mean of the committed local gradients; SCAFFOLD keeps sparse per-client
controls (zeros until first written), written back in arrival order,
last writer wins, with ``c_server`` taking ``sum(c_delta)/N`` a commit;
prox centers and ``decay`` advance on the commit counter.  Under
``sample_with_replacement`` a control-variate spec solves a client that
appears twice in one cohort in sequential occurrence layers
(:meth:`BufferedDriver._solve`), as the python driver does.

Each cohort solve is one call of ``client.make_batched_solver`` on the
trainer's device: on the card K2 under ``auto`` (paper logistic
regression), K3 under ``fused_step``, K1 under ``flat`` and K4 under
``per_leaf``.  The commit is plain tensor arithmetic, as in the
reference (no codec-aggregate kernel).

Determinism: one host ``np.random.default_rng(cfg.seed)`` stream, reset
at every :meth:`BufferedDriver.run`, drives sampling and the environment
in the reference's order per cohort launch (the gather selection of a
two-phase spec, then the solve cohort, then one ``(N,)`` uniform per
scenario channel), and event times are float64 host sums ordered by
``(done, seq)``.  A seed therefore gives the reference's event stream:
selections, arrival times, commit order and staleness.  Lossy codecs
draw from ``codecs.round_draws(spec, cfg, version, m, rows)`` where the
reference keys ``round_key(cfg, version)``.

On the client mesh (``mesh``, a
:class:`~repro_torch.core.sharding.ClientMesh`) every rank runs the same
host event queue from the same seed.  A cohort of m clients pads to
``ceil(m/D)·D`` rows (padded rows: all-zero valid masks); each rank
stacks and solves its rows only, and the results come back through
``sharding.gather_rows`` before the per-flight slicing, so every rank
holds every flight.  Phase A's gradient sums are summed over the ranks.
The commit buffer pads to a multiple of D as well, its padded rows
weighing 0, and the weighted numerator and weight sum are summed over
the ranks (``server.aggregate_buffered``).  Duplicates under a
control-variate spec solve in occurrence layers here too.

Degenerate parity (tests/test_torch_async.py): with ``buffer_size == K``,
a scenario without latency and fresh anchors every commit is a
synchronous round, equal to the python driver's at atol 1e-5.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.core import codecs
from repro_torch.core import pytree as pt
from repro_torch.core import server, sharding
from repro_torch.core.client import (make_batched_grad_fn,
                                     make_batched_solver, make_eval_loss)
from repro_torch.core.scenarios import (env_channels, is_trivial,
                                        realize_event_env, scenario_spec,
                                        staged_availability)
from repro_torch.core.strategies import (ControlCtx, CorrCtx, algorithm_spec,
                                         init_aux, make_server_opt)
from repro_torch.data.batching import stack_device_batches
from repro_torch.device import resolve_device
from repro_torch.kernels.flatpack import (LANES, flat_spec, pack,
                                          pack_broadcast, pack_stacked,
                                          unpack)

#: Safety factor on the event budget: a run processes at most
#: ``HORIZON_FACTOR * num_rounds * max(K, M)`` arrivals, then returns
#: its partial history (a config whose updates are all dropped or all
#: too stale ends instead of spinning).
HORIZON_FACTOR = 64


@dataclass(order=True)
class _Flight:
    """One in-flight client solve, ordered by (completion time, launch
    sequence): the event queue's order."""

    done: float
    seq: int
    client: int = field(compare=False)
    anchor_version: int = field(compare=False)
    launch: float = field(compare=False)
    delivered: bool = field(compare=False)
    delta: Any = field(compare=False)          # anchor - w_local (tree)
    g_local: Any = field(compare=False, default=None)
    c_new: Any = field(compare=False, default=None)
    c_delta: Any = field(compare=False, default=None)
    arrival: float = field(compare=False, default=0.0)


class _CommitBuffer:
    """Double-buffered commit staging area on the trainer's device.

    Arrivals are copied into row ``slot`` of the active ``(M, ...)``
    stack; at commit the full stack goes to the commit and the other one
    becomes active, so staging the next arrivals never writes the
    tensors the commit reads.
    """

    def __init__(self, params, m: int):
        self._bufs = [pt.tmap(lambda x: x.new_zeros((m,) + x.shape), params)
                      for _ in range(2)]
        self._active = 0

    def stage(self, slot: int, delta) -> None:
        """Write ``delta`` into row ``slot`` of the active stack."""
        for b, x in zip(pt.leaves(self._bufs[self._active]),
                        pt.leaves(delta)):
            b[slot].copy_(x)

    def swap(self):
        """Return the (full) active stack and flip to the other one."""
        full = self._bufs[self._active]
        self._active = 1 - self._active
        return full


class BufferedDriver:
    """The asynchronous buffered driver (module docstring).

    ``BufferedDriver(loss_fn, dataset, cfg, device=...)``; :meth:`run`
    has the trainer's signature and returns ``(history, params)``, where
    ``num_rounds`` counts server commits and the history carries the
    synchronous keys plus per-commit ``staleness_mean``,
    ``staleness_max``, ``buffer_wait``, ``anchor_age`` and ``sim_time``.
    ``device`` is the dataset's by default (the card unless it lives on
    the CPU).
    """

    def __init__(self, loss_fn: Callable, dataset, cfg, device=None,
                 mesh=None):
        """``mesh``: this rank's
        :class:`~repro_torch.core.sharding.ClientMesh` when
        ``cfg.mesh_devices`` asks for the client mesh (checked as the
        trainer checks it).  The cohorts always run on the batched
        solver."""
        #: the client mesh (core/sharding.py), or None: one process
        self.mesh = sharding.mesh_for(cfg, mesh)
        self._shards = sharding.num_shards(self.mesh)
        self.spec = algorithm_spec(cfg.algorithm)
        self.dataset = dataset
        self.cfg = cfg
        self.device = resolve_device(
            getattr(dataset, "device", None) if device is None else device)
        self.scn = scenario_spec(cfg.scenario)
        self._scn_trivial = is_trivial(self.scn)
        self._env_channels = env_channels(self.scn)
        self._has_work = self.scn.work_fraction is not None
        n = dataset.num_devices
        if self.spec.num_selections == 0:
            self._pool = n
        elif cfg.sample_with_replacement:
            self._pool = cfg.devices_per_round
        else:
            self._pool = min(cfg.devices_per_round, n)
        self._m = cfg.buffer_size or self._pool
        #: the commit buffer's rows: on the mesh padded up to a multiple
        #: of the rank count, the padding weighing 0 at every commit
        self._m_pad = -(-self._m // self._shards) * self._shards
        #: one batch of zeros in the dataset's layout: the rows a rank
        #: pads its part of a cohort with on the mesh
        self._zero_batch = None
        # client->server codec: encode at cohort LAUNCH (the client's
        # error feedback updates when it transmits); the flight carries
        # its DECODED delta, so staging and commit are codec-blind; the
        # server-side post-aggregate (dp_gauss noise) runs in the commit
        self._codec = codecs.codec_spec(cfg.codec)
        self._codec_trivial = codecs.is_trivial(self._codec)
        self.rng = np.random.default_rng(cfg.seed)
        self._solver = make_batched_solver(
            loss_fn, learning_rate=cfg.learning_rate,
            num_epochs=cfg.local_epochs, with_cutoff=self._has_work,
            solver=cfg.local_solver)
        self._grads = make_batched_grad_fn(loss_fn)
        self._server_opt = make_server_opt(self.spec, cfg)
        self._commit_fn = self._make_commit()
        self._eval_loss = make_eval_loss(loss_fn)
        self._sample_queue: List[np.ndarray] = []
        self._bytes_up = self._bytes_down = 0.0
        self._n_elems = 0

    # -- the commit -------------------------------------------------------

    def _make_commit(self) -> Callable:
        """The commit as one function: the staleness-weighted buffer
        mean, then the server (optimizer) step.  A codec with a
        server-side post-aggregate gets the variant that takes the
        commit's codec draws and update count; otherwise the exact
        codec-free commit."""
        opt, codec, cfg, mesh = (self._server_opt, self._codec, self.cfg,
                                 self.mesh)
        self._commit_takes_draws = (not self._codec_trivial
                                    and codec.post_aggregate is not None)
        if self._commit_takes_draws:
            def commit(w, opt_state, buf, weights, draws, count):
                pg = server.aggregate_buffered(buf, weights, mesh)
                fspec = flat_spec(w)
                flat = codec.post_aggregate(cfg, draws, pack(fspec, pg),
                                            torch.clamp(count, min=1.0))
                pg = unpack(fspec, flat)
                return server.server_step(w, pt.sub(w, pg), opt, opt_state)
        else:
            def commit(w, opt_state, buf, weights):
                pg = server.aggregate_buffered(buf, weights, mesh)
                return server.server_step(w, pt.sub(w, pg), opt, opt_state)
        return commit

    # -- sampling / environment -------------------------------------------

    def _sample(self, m: int) -> np.ndarray:
        """An ``m``-client selection from the host stream: the python
        driver's sampler and, degenerately, its stream order."""
        p = self.dataset.weights if self.cfg.weighted_sampling else None
        return server.sample_devices(
            self.rng, self.dataset.num_devices, m, p=p,
            replace=self.cfg.sample_with_replacement)

    def _cohort_selections(
            self, m: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(solve cohort, gather selection) of a launch of ``m`` clients,
        by the spec's phases; an injected ``selections`` row is consumed
        per cohort launch (a refill takes its first ``m`` solve
        entries)."""
        spec = self.spec
        if self._sample_queue:
            row = np.asarray(self._sample_queue.pop(0))
            phases = [row] if row.ndim == 1 else list(row)
            if spec.num_selections == 2:
                s1 = np.asarray(phases[0], dtype=np.int64)
                s2 = np.asarray(phases[-1], dtype=np.int64)[:m]
                return s2, s1
            return np.asarray(phases[0], dtype=np.int64)[:m], None
        if spec.num_selections == 2:
            # the gather keeps the full width K; the solve cohort only
            # refills the freed slots
            s1 = self._sample(self.cfg.devices_per_round)
            return self._sample(m), s1
        return self._sample(m), None

    def _launch_uniforms(self) -> Optional[Dict[str, torch.Tensor]]:
        """One ``(N,)`` float32 uniform per scenario channel, drawn per
        cohort launch from the host stream, on the CPU (``ideal`` draws
        nothing)."""
        if self._scn_trivial:
            return None
        n = self.dataset.num_devices
        return {c: torch.from_numpy(self.rng.random(n)).to(torch.float32)
                for c in self._env_channels}

    # -- the cohort solve -------------------------------------------------

    def _solve_cohort(self, w, corr, mu, b, v, limit):
        """One batched local solve of an m-client cohort; ``limit`` the
        host's int32 step caps (``None`` without a work assignment)."""
        if limit is None:
            return self._solver(w, corr, mu, b, v)
        return self._solver(w, corr, mu, b, v,
                            torch.from_numpy(limit).to(self.device))

    def _stack_rows(self, ids, nb: int, rows: int, example: int):
        """``ids``' batch stacks at ``nb`` batches, then zero rows (an
        all-zero valid mask: identity steps, zero gradients) up to
        ``rows``: a rank's part of a cohort padded to the mesh.  Client
        ``example`` of the cohort gives the zero rows' layout when the
        rank holds no row of its own."""
        parts = ([stack_device_batches(self.dataset, ids, nb=nb)]
                 if len(ids) else [])
        pad = rows - len(ids)
        if pad == 0:
            return parts[0]
        if self._zero_batch is None:
            like = (pt.tmap(lambda x: x[0], parts[0][0]) if parts
                    else self.dataset.device_batches(example))
            self._zero_batch = pt.tmap(lambda x: torch.zeros_like(x[0]),
                                       like)
        parts.append((
            pt.tmap(lambda z: z.expand((pad, nb) + z.shape).clone(),
                    self._zero_batch),
            torch.zeros((pad, nb), dtype=torch.float32, device=self.device)))
        if len(parts) == 1:
            return parts[0]
        (b, v), (zb, zv) = parts
        return (pt.tmap(lambda x, z: torch.cat([x, z]), b, zb),
                torch.cat([v, zv]))

    def _gather_grad(self, w, gather: np.ndarray):
        """Phase A's mean gradient over the selection ``gather``.  On the
        client mesh the selection pads to a multiple of the rank count
        with zero rows (zero gradients), each rank sums its rows'
        gradients and the sums are summed over the ranks
        (``tree_psum``) before the division by the count."""
        g = len(gather)
        lo, hi = sharding.shard_rows(-(-g // self._shards) * self._shards,
                                     self.mesh)
        nb = max(self.dataset.num_batches(k) for k in gather)
        b, v = self._stack_rows(gather[lo:min(hi, g)], nb, hi - lo,
                                int(gather[0]))
        grads = self._grads(w, b, v)
        if self.mesh is None:
            return pt.tmap(lambda x: x.mean(dim=0), grads)
        sums = sharding.tree_psum(pt.tmap(lambda x: x.sum(dim=0), grads),
                                  self.mesh)
        return pt.tmap(lambda x: x / float(g), sums)

    def _solve(self, cohort: np.ndarray, w, aux, limit, corr_for, mu):
        """The cohort solve: ``(params, g_local, c_new, c_delta)`` as
        ``(m, ...)`` stacks in cohort order, on every rank (``None``
        where the spec keeps none).

        On the client mesh the cohort pads to a multiple of the rank
        count; each rank stacks, corrects and solves its rows only
        (padded rows: all-zero valid masks, a step cap of 0), and the
        results come back through one ``sharding.gather_rows``.  A
        control-variate spec whose cohort holds a client twice
        (``sample_with_replacement``) solves in occurrence layers:
        cohort position ``i`` belongs to layer ``L`` = the number of
        earlier positions holding the same client, and each layer reads
        the controls the previous layer refreshed (the python driver's
        per-duplicate semantics; the corrections read the launch-time
        ``c_server``)."""
        spec, cfg, mesh = self.spec, self.cfg, self.mesh
        m = len(cohort)
        ctl = spec.control_update is not None
        zeros = pt.zeros_like(w)
        live = ({int(k): aux["controls"].get(int(k), zeros) for k in cohort}
                if ctl else {})
        occ = np.zeros((m,), np.int64)
        if ctl:
            seen: Dict[int, int] = {}
            for i, k in enumerate(cohort):
                occ[i] = seen.get(int(k), 0)
                seen[int(k)] = int(occ[i]) + 1
        layers = int(occ.max()) + 1
        nb = max(self.dataset.num_batches(k) for k in cohort)
        keys = ("params", "g_local", "c_new", "c_delta")
        out: Dict[str, List[Any]] = {}
        for layer in range(layers):
            idx = np.nonzero(occ == layer)[0]
            ml = len(idx)
            lo, hi = sharding.shard_rows(
                -(-ml // self._shards) * self._shards, mesh)
            mine = idx[lo:min(hi, ml)]
            pad = (hi - lo) - len(mine)
            b, v = self._stack_rows(cohort[mine], nb, hi - lo,
                                    int(cohort[0]))
            g_rows = self._grads(w, b, v) if spec.local_grad else None
            c_stack = (pt.stack([live[int(cohort[i])] for i in mine]
                                + [zeros] * pad) if ctl else None)
            lim = (None if limit is None else np.concatenate(
                [limit[mine], np.zeros((pad,), limit.dtype)]))
            res = self._solve_cohort(w, corr_for(c_stack, g_rows, hi - lo),
                                     mu, b, v, lim)
            parts = {"params": res.params}
            if spec.updates_g_prev:
                parts["g_local"] = g_rows
            if ctl:
                inv_steps = 1.0 / (torch.clamp(res.num_steps, min=1)
                                   * cfg.learning_rate)
                c_new = spec.control_update(ControlCtx(
                    c_local=c_stack, c_server=aux["c_server"], w0=w,
                    w_new=res.params, inv_steps=inv_steps))
                parts["c_new"] = c_new
                parts["c_delta"] = pt.sub(c_new, c_stack)
            parts = sharding.gather_rows(parts, mesh)
            if layers == 1:
                # the cohort in order, then the mesh's padded rows
                return tuple(pt.tmap(lambda x: x[:m], parts[key])
                             if key in parts else None for key in keys)
            for j, i in enumerate(idx):
                for key, x in parts.items():
                    out.setdefault(key, [None] * m)[i] = pt.index(x, j)
                live[int(cohort[i])] = out["c_new"][i]
        return tuple(pt.stack(out[key]) if key in out else None
                     for key in keys)

    # -- the cohort launch ------------------------------------------------

    def _launch(self, cohort: np.ndarray, s1: Optional[np.ndarray], w,
                aux: Dict[str, Any], version: int, now: float,
                seq0: int) -> List[_Flight]:
        """Solve ``cohort`` against the anchor ``w`` (the server params at
        launch) and return one :class:`_Flight` per client with its
        completion time and commit payload.  Every launch-time read (the
        gather gradient, ``g_prev``, controls, the center, the decay)
        snapshots the server state as of this launch, so out-of-order
        commits never reach back into mutated state."""
        spec, cfg, dev = self.spec, self.cfg, self.device
        n = self.dataset.num_devices
        m = len(cohort)
        uniforms = self._launch_uniforms()
        if uniforms is not None:
            env = realize_event_env(self.scn, cfg, n,
                                    torch.from_numpy(cohort), version,
                                    uniforms)
            delivered = env.delivered.numpy() > 0
            work = env.work.numpy()
            latency = env.latency.numpy()
        else:
            delivered = np.ones((m,), bool)
            work = None
            latency = np.ones((m,), np.float64)

        mu = cfg.mu if spec.use_mu else 0.0
        decay = spec.decay(cfg, version) if spec.decay is not None else 1.0

        # phase A: the gradient gather, against THIS launch's anchor
        g_global = None
        gather_n = 0.0
        if spec.grad_source == "fresh":
            gather = np.asarray(s1 if s1 is not None else cohort)
            if self.scn.availability is not None and uniforms is not None:
                p = staged_availability(self.scn, cfg, n, version).numpy()
                gather = gather[uniforms["avail"].numpy()[gather]
                                < p[gather]]
            gather_n = float(len(gather))
            if len(gather) > 0:
                g_global = self._gather_grad(w, gather)
        elif spec.grad_source == "stale":
            g_global = aux.get("g_prev")

        def corr_for(c_stack_, g_local_, mm):
            if spec.correction is not None and not (
                    spec.grad_source == "fresh" and g_global is None):
                return spec.correction(CorrCtx(
                    w0=w, g_global=g_global, g_local=g_local_,
                    c_server=aux.get("c_server"), c_local=c_stack_,
                    center=aux.get("center"), mu=mu, decay=decay))
            return pt.tmap(lambda x: x.new_zeros((mm,) + x.shape), w)

        limit = None
        if self._has_work:
            # the step caps on the host, in the reference's numpy dtypes
            # (float32 valid counts and work fractions)
            nbs = np.asarray([self.dataset.num_batches(k)
                              for k in cohort])
            valid = (np.arange(nbs.max())[None, :] < nbs[:, None]).astype(
                np.float32)
            total = cfg.local_epochs * valid.sum(axis=1)
            wf = work if work is not None else np.ones((m,))
            limit = np.minimum(total, np.ceil(wf * total)).astype(np.int32)

        res_params, g_local, c_new, c_delta = self._solve(
            cohort, w, aux, limit, corr_for, mu)

        # codec encode at launch, slots 0..m-1; the flight carries the
        # DECODED delta (post_decode is linear, so per client is valid);
        # error feedback refreshes only for updates that will be delivered
        dec = fspec = None
        if not self._codec_trivial:
            codec = self._codec
            fspec = flat_spec(w)
            draws = codecs.round_draws(codec, cfg, version, m, fspec.rows,
                                       dev)
            deltas = (pack_broadcast(fspec, w, m)
                      - pack_stacked(fspec, res_params, m)
                      ).reshape(m, fspec.rows, LANES)
            efs = None
            if codec.error_feedback:
                zero = torch.zeros((fspec.rows, LANES), dtype=torch.float32,
                                   device=dev)
                efs = torch.stack([aux["ef"].get(int(k), zero)
                                   for k in cohort])
            vals, scales, ef_new = codecs.encode_stacked(codec, cfg, draws,
                                                         deltas, efs)
            dec = vals * scales[:, None, None]
            if codec.post_decode is not None:
                dec = torch.stack([codec.post_decode(cfg, draws, x)
                                   for x in dec])
            if ef_new is not None:
                for i, k in enumerate(cohort):
                    if delivered[i]:
                        aux["ef"][int(k)] = ef_new[i]

        # wire bytes at launch: the anchor (+ correction) to the cohort,
        # the anchor to and dense gradients from the thinned gather; the
        # update uplink accrues at arrival, in run()'s event loop
        dense = codecs.DENSE_BYTES * self._n_elems
        corr_down = 1.0 if spec.correction is not None else 0.0
        self._bytes_down += dense * gather_n + dense * (1.0 + corr_down) * m
        self._bytes_up += dense * gather_n

        flights = []
        for i, k in enumerate(cohort):
            flights.append(_Flight(
                done=now + float(latency[i]), seq=seq0 + i, client=int(k),
                anchor_version=version, launch=now,
                delivered=bool(delivered[i]),
                delta=(pt.sub(w, pt.index(res_params, i)) if dec is None
                       else unpack(fspec, dec[i])),
                g_local=(pt.index(g_local, i) if spec.updates_g_prev
                         else None),
                c_new=None if c_new is None else pt.index(c_new, i),
                c_delta=None if c_delta is None else pt.index(c_delta, i)))
        return flights

    # -- evaluation -------------------------------------------------------

    def global_loss(self, params) -> float:
        """f(w) = sum_k p_k F_k(w) over the eval split (eq. 1); one host
        sync."""
        weights, losses = [], []
        for wk, batches in self.dataset.eval_batches():
            weights.append(wk)
            losses.append(self._eval_loss(params, batches))
        total, wsum = 0.0, 0.0
        for wk, loss in zip(weights, torch.stack(losses).tolist()):
            total += wk * loss
            wsum += wk
        return total / max(wsum, 1e-12)

    # -- the event loop ---------------------------------------------------

    def run(self, params, num_rounds: int, eval_every: int = 1,
            verbose: bool = False, checkpoint_dir: Optional[str] = None,
            selections=None) -> Tuple[Dict[str, List[float]], Any]:
        """Simulate until ``num_rounds`` server commits (or the event
        horizon) and return ``(history, final_params)``.

        The rng is re-seeded from ``cfg.seed`` at every call, so each
        run repeats the same event stream.  ``selections``: one
        ``(2, K)`` / ``(K,)`` row consumed per cohort launch.
        ``checkpoint_dir``: ``{"params", "round"}`` saved at every
        commit that is a multiple of ``cfg.chunk_rounds`` and at the
        last (``checkpoint/store.py``, the reference's files and bytes).
        """
        cfg, spec, dev = self.cfg, self.spec, self.device
        self.rng = np.random.default_rng(cfg.seed)
        self._sample_queue = (
            [np.asarray(r) for r in np.asarray(selections)]
            if selections is not None else [])

        w = pt.tmap(lambda x: x.detach().to(dev), params)
        aux: Dict[str, Any] = init_aux(spec, cfg, w,
                                       self.dataset.num_devices)
        if "controls" in aux:
            aux["controls"] = {}          # sparse: zeros until first commit
        if self._codec.error_feedback:
            aux["ef"] = {}                # sparse: zeros until first launch
        opt_state = aux.get("opt")
        self._n_elems = sum(x.numel() for x in pt.leaves(w))
        self._bytes_up = self._bytes_down = 0.0
        dense = codecs.DENSE_BYTES * self._n_elems
        enc = (self._codec.uplink_bytes(cfg, self._n_elems)
               if self._codec.uplink_bytes is not None else dense)
        grad_up = dense if spec.updates_g_prev else 0.0
        rows = flat_spec(w).rows
        buffer = _CommitBuffer(w, self._m_pad)
        pending: List[_Flight] = []       # metadata of the staged updates
        inflight: List[_Flight] = []      # heap by (done, seq)
        version = 0                       # commits so far
        now = 0.0
        seq = 0
        consumed = 0                      # arrivals since the last commit
        budget = HORIZON_FACTOR * max(1, num_rounds) * max(self._pool,
                                                           self._m)
        hist: Dict[str, List[float]] = {
            "round": [], "comm_rounds": [], "loss": [],
            "intended_k": [], "effective_k": [], "dropped": [],
            "staleness_mean": [], "staleness_max": [],
            "buffer_wait": [], "anchor_age": [], "sim_time": [],
            "bytes_up": [], "bytes_down": []}
        chunk = cfg.chunk_rounds if cfg.chunk_rounds > 0 else num_rounds

        def launch(cohort_hint: Optional[List[int]] = None) -> None:
            nonlocal seq
            m = self._pool - len(inflight)
            if m <= 0 or version >= num_rounds:
                return
            if spec.num_selections == 0:
                # full participation: relaunch exactly the freed clients
                cohort = np.asarray(
                    cohort_hint if cohort_hint is not None
                    else range(self.dataset.num_devices), dtype=np.int64)
                s1 = None
            else:
                cohort, s1 = self._cohort_selections(m)
            for f in self._launch(cohort, s1, w, aux, version, now, seq):
                heapq.heappush(inflight, f)
            seq += len(cohort)

        def commit() -> None:
            nonlocal w, opt_state, version, consumed
            stal = np.asarray(
                [version - f.anchor_version for f in pending], np.float32)
            weights = server.staleness_weight(
                cfg.staleness_fn, torch.from_numpy(stal)).to(dev)
            # the mesh's padded buffer rows weigh 0
            wpad = (weights if self._m_pad == self._m else torch.cat(
                [weights, weights.new_zeros(self._m_pad - self._m)]))
            if self._commit_takes_draws:
                draws = codecs.round_draws(self._codec, cfg, version, 0,
                                           rows, dev)
                count = torch.full((), float(len(pending)),
                                   dtype=torch.float32, device=dev)
                w, opt_state = self._commit_fn(w, opt_state, buffer.swap(),
                                               wpad, draws, count)
            else:
                w, opt_state = self._commit_fn(w, opt_state, buffer.swap(),
                                               wpad)
            if spec.updates_g_prev:
                aux["g_prev"] = server.aggregate_buffered(
                    pt.stack([f.g_local for f in pending]), weights)
            if spec.control_update is not None:
                for f in pending:         # arrival order: last writer wins
                    aux["controls"][f.client] = f.c_new
                csum = pending[0].c_delta
                for f in pending[1:]:
                    csum = pt.add(csum, f.c_delta)
                aux["c_server"] = pt.add(
                    aux["c_server"],
                    pt.scale(csum, 1.0 / self.dataset.num_devices))
            if spec.center_update is not None:
                aux["center"] = spec.center_update(aux["center"], w, cfg)
            version += 1
            hist["intended_k"].append(float(consumed))
            hist["effective_k"].append(float(len(pending)))
            hist["dropped"].append(float(consumed - len(pending)))
            hist["staleness_mean"].append(float(stal.mean()))
            hist["staleness_max"].append(float(stal.max()))
            hist["buffer_wait"].append(
                now - min(f.arrival for f in pending))
            hist["anchor_age"].append(
                float(np.mean([now - f.launch for f in pending])))
            hist["sim_time"].append(now)
            hist["bytes_up"].append(self._bytes_up)
            hist["bytes_down"].append(self._bytes_down)
            self._bytes_up = self._bytes_down = 0.0
            pending.clear()
            consumed = 0
            if (version - 1) % eval_every == 0 or version == num_rounds:
                loss = self.global_loss(w)
                hist["round"].append(float(version))
                hist["comm_rounds"].append(
                    float(version * spec.comm_per_round))
                hist["loss"].append(loss)
                if verbose:
                    print(f"[{cfg.algorithm}/buffered] commit "
                          f"{version:4d} t={now:8.2f} loss {loss:.4f}")
            if checkpoint_dir is not None and (
                    version % chunk == 0 or version == num_rounds):
                save_checkpoint(checkpoint_dir,
                                {"params": w, "round": version},
                                step=version)

        launch()
        while version < num_rounds and inflight and budget > 0:
            group: List[_Flight] = [heapq.heappop(inflight)]
            now = group[0].done
            while inflight and inflight[0].done == now:
                group.append(heapq.heappop(inflight))
            for f in group:               # seq order within the instant
                if version >= num_rounds:
                    break
                budget -= 1
                consumed += 1
                f.arrival = now
                stale = version - f.anchor_version
                if f.delivered:
                    # the encoded update crossed the wire: a staleness-
                    # dropped arrival still spent the uplink bytes
                    self._bytes_up += enc + grad_up
                if not f.delivered or (cfg.max_staleness > 0
                                       and stale > cfg.max_staleness):
                    continue
                buffer.stage(len(pending), f.delta)
                pending.append(f)
                if len(pending) == self._m:
                    commit()
            launch(cohort_hint=[f.client for f in group])
        return hist, w
