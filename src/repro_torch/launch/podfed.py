"""Pod-as-client federated rounds: Alg. 2 with each pod one client.

Counterpart of ``repro/launch/podfed.py``.  Per-client state carries a
leading ``num_pods`` dim, so the clients diverge over E > 0 local steps
inside one round, and the two FedDANE aggregations are means over the
pods:

  phase A:  g_t = mean_pods( grad F_k(anchor) )        (Alg. 2 line 6)
  phase B:  w^t = mean_pods( w_k after E local steps )  (Alg. 2 line 9)

In one process the pods are the leading dim, solved one after another.
On a :class:`~repro_torch.core.sharding.ClientMesh` of D ranks (started
by ``core.sharding.run_on_mesh``) each rank holds ``num_pods / D`` pods
-- the leading dim of the state and batch it is handed -- and both means
are its local mean, then ``sharding.tree_pmean`` over the ranks (every
rank holding the same count, the mean of all pods).  The reference's
XLA shardings inside a pod (``_client_pspecs``: FSDP over ``data``,
tensor parallel over ``model``) are not ported: a pod is one rank here.
The archs are those of the train steps (``steps.check_trainable``): the
dense archs, the MoE archs, the hybrid jamba-v0.1-52b, whose pod loss
adds the MoE blocks' aux, xlstm-350m, and the encoder-decoder
whisper-tiny, whose batch carries frames ``(pods, local_steps, b, S, d)``
beside the tokens and labels.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import pytree as pt
from repro_torch.core import sharding
from repro_torch.launch import steps
from repro_torch.launch.steps import ShapeDtype
from repro_torch.models import transformer

STATE_KEYS = ("params", "anchor", "g_t")


def _pod_mean(trees, mesh: Optional[sharding.ClientMesh]):
    """The mean over every pod of ``trees`` (this rank's pods, in order)."""
    return sharding.tree_pmean(pt.mean(trees), mesh)


def make_podfed_round_step(cfg: ModelConfig,
                           mesh: Optional[sharding.ClientMesh] = None, *,
                           eta: float = 1e-3, mu: float = 0.01,
                           local_steps: int = 1,
                           remat: str = "full") -> Tuple[Callable, Dict]:
    """Returns ``(round_fn, info)``.  ``round_fn(state, batch)``: state
    leaves carry a leading pod dim (this rank's pods), the batch is
    ``(pods, local_steps, per_client_batch, S)``; returns the new state
    (every pod at the mean iterate, ``g_t`` the phase-A mean) and
    ``{"loss": the pods' mean loss at the new iterate on their first
    batch}``."""
    steps.check_trainable(cfg)
    if local_steps < 1:
        raise ValueError(f"local_steps={local_steps} must be >= 1")

    def local_loss(p, b):
        return transformer.loss_fn(p, b, cfg, remat=remat)

    def grad_at(p, b):
        return steps.value_and_grad(lambda q: local_loss(q, b), p)[1]

    def round_fn(state, batch):
        pods = pt.leaves(state["params"])[0].shape[0]
        if pt.leaves(batch)[0].shape[:2] != (pods, local_steps):
            raise ValueError(
                f"podfed: batch leading dims "
                f"{tuple(pt.leaves(batch)[0].shape[:2])} != (pods, "
                f"local_steps) = ({pods}, {local_steps})")
        params = [pt.index(state["params"], i) for i in range(pods)]
        anchor = [pt.index(state["anchor"], i) for i in range(pods)]
        first = [pt.tmap(lambda x: x[i, 0], batch) for i in range(pods)]
        # phase A: each pod's gradient at its anchor, then the pod mean
        g_anchor = [grad_at(a, b) for a, b in zip(anchor, first)]
        g_t = _pod_mean(g_anchor, mesh)
        # phase B: E local DANE-subproblem steps a pod (clients diverge)
        w_k = []
        for i in range(pods):
            corr = pt.sub(g_t, g_anchor[i])
            w = params[i]
            for s in range(local_steps):
                b = pt.tmap(lambda x: x[i, s], batch)
                w = steps._dane_step(w, grad_at(w, b), corr, anchor[i],
                                     eta, mu)
            w_k.append(w)
        # aggregation: the iterate mean over the pods
        w_new = _pod_mean(w_k, mesh)
        with torch.no_grad():
            losses = [local_loss(w_new, b) for b in first]
        loss = sharding.tree_pmean(sum(losses[1:], losses[0]) / pods, mesh)

        def per_pod(tree):
            return pt.tmap(
                lambda x: x.unsqueeze(0).expand((pods,) + x.shape)
                .contiguous(), tree)

        stacked = per_pod(w_new)
        return ({"params": stacked, "anchor": stacked, "g_t": per_pod(g_t)},
                {"loss": loss})

    info = {"mesh_devices": sharding.num_shards(mesh),
            "local_steps": local_steps, "state_keys": STATE_KEYS}
    return round_fn, info


def abstract_podfed_args(cfg: ModelConfig, shape: InputShape,
                         num_pods: int, *, local_steps: int = 1,
                         dtype=torch.bfloat16):
    """The round's inputs as :class:`ShapeDtype` trees, shapes only:
    the state with a leading ``num_pods`` dim, the batch as ``(num_pods,
    local_steps, global_batch / num_pods / local_steps, S)``.  The
    reference also attaches XLA shardings (``_client_pspecs``), which
    the port does not have."""
    per_client = shape.global_batch // num_pods // local_steps
    if per_client < 1:
        raise ValueError(f"global batch {shape.global_batch} too small for "
                         f"{num_pods} pods x {local_steps} steps")
    one = pt.tmap(lambda s: ShapeDtype((num_pods,) + s.shape, dtype),
                  transformer.model_specs(cfg))
    inner = steps.train_batch_specs(
        cfg, InputShape(shape.name, shape.seq_len, per_client, "train"))
    batch = {k: ShapeDtype((num_pods, local_steps) + s.shape, s.dtype)
             for k, s in inner.items()}
    return {k: one for k in STATE_KEYS}, batch
