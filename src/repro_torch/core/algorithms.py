"""Federated optimization trainer (paper Alg. 1 & 2 + §V-C variants).

Counterpart of ``repro/core/algorithms.py`` for the synchronous python
driver under the ideal scenario and the dense codec.
``FederatedTrainer`` interprets the registered
:class:`~repro_torch.core.strategies.AlgorithmSpec` of
``cfg.algorithm`` on one of two engines (``FederatedConfig.engine``):

- ``"batched"``: the K selected devices stacked and solved in lockstep
  by :class:`~repro_torch.core.engine.RoundEngine` -- on the card
  through the hand-written kernels;
- ``"loop"``: the per-device reference with plain tree-op updates;
- ``"auto"`` (default): batched on the card, loop on the CPU.

Sampling uses the reference's numpy stream (``default_rng(cfg.seed)``),
so a seed gives the reference's selections under either engine.  The
trainer runs on ``device`` -- the card unless ``device="cpu"`` -- and
the dataset must live there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import pytree as pt
from repro_torch.core import server
from repro_torch.core.client import make_grad_fn, make_local_solver
from repro_torch.core.codecs import round_bytes
from repro_torch.core.engine import RoundEngine
from repro_torch.core.strategies import (ControlCtx, CorrCtx, algorithm_spec,
                                         init_aux, make_server_opt,
                                         runtime_state_fields)
from repro_torch.data.batching import num_batches_of, stack_device_batches
from repro_torch.device import resolve_device


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


class FederatedTrainer:
    """Simulates N devices + central server on one host (paper §V).

    ``dataset`` provides ``num_devices``, ``weights`` (p_k),
    ``device_batches(k)`` and ``eval_batches()``, with tensors on
    ``device``; ``loss_fn(params, batch) -> scalar`` must work under
    ``torch.func.grad``/``vmap``.
    """

    def __init__(self, loss_fn: Callable, dataset, cfg: FederatedConfig,
                 device=None):
        self.device = resolve_device(device)
        data_dev = getattr(dataset, "device", None)
        if data_dev is not None and torch.device(data_dev) != self.device:
            raise ValueError(f"dataset lives on {data_dev}, trainer runs "
                             f"on {self.device}")
        self.loss_fn = loss_fn
        self.dataset = dataset
        self.cfg = cfg
        self.spec = algorithm_spec(cfg.algorithm)
        #: (S1, S2) of the most recent round
        self.last_selection: Optional[Tuple[np.ndarray, np.ndarray]] = None
        #: (phase-A gather devices, solve devices) of the last round
        self.last_comm: Optional[Tuple[float, float]] = None
        self.rng = np.random.default_rng(cfg.seed)
        self.solver = make_local_solver(
            loss_fn, learning_rate=cfg.learning_rate,
            num_epochs=cfg.local_epochs)
        self.grad_fn = make_grad_fn(loss_fn)
        self._server_opt = make_server_opt(self.spec, cfg)
        self._state_fields = runtime_state_fields(self.spec, cfg)
        engine = cfg.engine
        if engine == "auto":
            engine = "batched" if self.device.type == "cuda" else "loop"
        self.engine: Optional[RoundEngine] = (
            RoundEngine(loss_fn, cfg, spec=self.spec,
                        num_devices=dataset.num_devices)
            if engine == "batched" else None)
        self._sample_queue: List[np.ndarray] = []       # test injection
        self._eval_loss = _make_eval_loss(loss_fn)

    # -- helpers ----------------------------------------------------------

    def _sample(self) -> np.ndarray:
        if self._sample_queue:
            return np.asarray(self._sample_queue.pop(0), dtype=np.int64)
        p = self.dataset.weights if self.cfg.weighted_sampling else None
        return server.sample_devices(
            self.rng, self.dataset.num_devices, self.cfg.devices_per_round,
            p=p, replace=self.cfg.sample_with_replacement)

    def _batches(self, k: int):
        return self.dataset.device_batches(int(k))

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
        """Advance one federated round in place and return ``st``."""
        spec, cfg = self.spec, self.cfg
        w0 = st.params
        mu = cfg.mu if spec.use_mu else 0.0
        decay = (spec.decay(cfg, st.round)
                 if spec.decay is not None else 1.0)
        eng = self.engine
        # duplicated selections must update controls sequentially; the
        # batched scatter would apply them once -> the looped path
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
        gather_n = float(len(S1)) if spec.grad_source == "fresh" else 0.0
        self.last_comm = (gather_n, float(len(S2)))

        if eng is not None:
            b, v = stack_device_batches(self.dataset, S2)
            phase_a = (stack_device_batches(self.dataset, S1)
                       if spec.grad_source == "fresh" and not shared
                       else None)
            aux = self._gather_aux(st, S2)
            st.params, aux_new = eng.round(w0, aux, phase_a, b, v, decay)
            self._scatter_aux(st, aux_new, S2)
        else:
            self._loop_round(st, S1, S2, mu, decay)
        st.comm_rounds += spec.comm_per_round
        st.round += 1
        return st

    def _loop_round(self, st: FederatedState, S1, S2, mu, decay) -> None:
        """Per-device reference interpretation of the spec: one solve or
        gradient call per device, plain tree-op aggregation."""
        spec, cfg = self.spec, self.cfg
        w0 = st.params
        zeros = pt.zeros_like(w0)

        g_global = None
        if spec.grad_source == "fresh":
            g_global = server.aggregate_gradients(
                [self.grad_fn(w0, self._batches(k)) for k in S1])
        elif spec.grad_source == "stale":
            g_global = st.g_prev

        c0 = st.c_server
        updates, fresh_grads, deltas = [], [], []
        for k in S2:
            bk = self._batches(k)
            g_local = self.grad_fn(w0, bk) if spec.local_grad else None
            if spec.updates_g_prev:
                fresh_grads.append(g_local)
            if spec.correction is not None:
                corr = spec.correction(CorrCtx(
                    w0=w0, g_global=g_global, g_local=g_local,
                    c_server=c0,
                    c_local=(st.controls[int(k)]
                             if st.controls is not None else None),
                    center=st.center, mu=mu, decay=decay))
            else:
                corr = zeros
            nsteps = cfg.local_epochs * num_batches_of(bk)
            res = self.solver(w0, corr, mu, bk)
            updates.append(res.params)
            if spec.control_update is not None:
                # option II: corrections used the ROUND-START server
                # control; duplicates refresh the device control in turn
                ck_new = spec.control_update(ControlCtx(
                    c_local=st.controls[int(k)], c_server=c0, w0=w0,
                    w_new=res.params,
                    inv_steps=1.0 / (max(nsteps, 1) * cfg.learning_rate)))
                deltas.append(pt.sub(ck_new, st.controls[int(k)]))
                st.controls[int(k)] = ck_new

        w_agg = server.aggregate_mean(updates) if updates else w0
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

    def run(self, params, num_rounds: int, eval_every: int = 1,
            verbose: bool = False,
            selections=None) -> Tuple[Dict[str, List[float]], Any]:
        """Run ``num_rounds`` rounds; returns ``(history, final_params)``
        with the reference's history keys: ``round`` / ``comm_rounds`` /
        ``loss`` at eval cadence, and per round ``intended_k`` /
        ``effective_k`` / ``dropped`` (K / K / 0 under the ideal
        scenario) and the wire bytes ``bytes_up`` / ``bytes_down``.

        ``selections``: optional ``(num_rounds, 2, K)`` (or
        ``(num_rounds, K)``) int array overriding device sampling round
        by round -- row 0 feeds single-selection algorithms and FedDANE
        phase A, row 1 phase B.
        """
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

        st = self.init(params)
        n_elems = sum(x.numel() for x in pt.leaves(st.params))
        hist: Dict[str, List[float]] = {"round": [], "comm_rounds": [],
                                        "loss": [], "intended_k": [],
                                        "effective_k": [], "dropped": [],
                                        "bytes_up": [], "bytes_down": []}
        try:
            for t in range(num_rounds):
                st = self.round(st)
                k = float(len(self.last_selection[1]))
                hist["intended_k"].append(k)
                hist["effective_k"].append(k)
                hist["dropped"].append(0.0)
                up, down = round_bytes(self.spec, n_elems, *self.last_comm)
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
        finally:
            # injected selections must never leak into a later run()
            self._sample_queue.clear()
        return hist, st.params


def _make_eval_loss(loss_fn: Callable) -> Callable:
    """Per-device eval loss: the mean batch loss over the device's
    ``(nb, batch, ...)`` stack, as a 0-dim tensor on the device."""
    per_batch = vmap(loss_fn, in_dims=(None, 0))

    def f(p, b):
        return per_batch(p, b).sum() / num_batches_of(b)

    return f
