"""Step functions of the LM stack and the shapes of their inputs.

Counterpart of ``repro/launch/steps.py``:

- train_4k -> ``make_feddane_round_step``: one FedDANE round
  participation -- phase A's gradient at the server anchor, then one
  DANE-subproblem step from the current params with the server gradient
  ``g_t`` carried in the train state (the technique's two extra
  model-sized buffers, anchor and g_t); ``make_fedavg_step`` (no
  correction, one forward and backward) and
  ``make_feddane_pipelined_step`` (§V-C: the stale correction, one
  forward and backward) beside it, all three in ``STEP_BUILDERS``;
- ``make_prefill_step`` and ``make_decode_step``, the programs a server
  runs;
- the shapes and dtypes of their inputs: ``train_state_specs`` /
  ``abstract_train_state``, ``train_batch_specs``,
  ``prefill_batch_specs``, ``decode_batch_specs``,
  ``abstract_decode_cache``.

The train steps take gradients with ``torch.autograd.grad`` (so every
remat policy works; on the card attention goes through K7 and its
backward), return new state dicts and never write into their inputs.
Serving and training take the dense archs, the MoE ones
(qwen3-moe-235b-a22b, arctic-480b), the hybrid jamba-v0.1-52b (its
mamba blocks' scan through K8, and its gradient through K8-bwd, on the
card), xlstm-350m (its mLSTM and sLSTM scans through K9 and K10, and
their gradients through K9-bwd and K10-bwd, on the card) and the
encoder-decoder whisper-tiny (frames for its encoder beside the tokens;
its three attentions through K7 and K7-bwd on the card); the loss adds
the MoE blocks' load-balance aux.  :func:`check_trainable` refuses what
the model refuses (the patch frontend) as not yet ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import pytree as pt
from repro_torch.models import transformer


@dataclass(frozen=True)
class ShapeDtype:
    """A tensor's shape and dtype (the reference's ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# Train state and batches
# ---------------------------------------------------------------------------

def check_trainable(cfg: ModelConfig) -> None:
    """Raise unless the train side takes ``cfg``: every block kind the
    model takes (``attn``, ``attn_moe``, ``mamba``, ``mamba_moe``,
    ``mlstm``, ``slstm``) and the encoder-decoder; the patch frontend is
    refused as not yet ported."""
    transformer._check_ported(cfg)


def train_state_specs(cfg: ModelConfig, algo: str = "feddane") -> dict:
    """ParamSpec tree of the train state: FedDANE carries anchor and g_t
    beside the params."""
    check_trainable(cfg)
    p = transformer.model_specs(cfg)
    if algo == "fedavg":
        return {"params": p}
    return {"params": p, "anchor": p, "g_t": p}


def abstract_train_state(cfg: ModelConfig, algo: str = "feddane",
                         dtype=torch.bfloat16) -> dict:
    return pt.tmap(lambda s: ShapeDtype(s.shape, dtype),
                   train_state_specs(cfg, algo))


def train_batch_specs(cfg: ModelConfig, shape: InputShape,
                      dtype=torch.bfloat16) -> Dict[str, ShapeDtype]:
    """Tokens and labels, (B, S) int32, and for an encoder-decoder the
    frames (B, S, d) in the activation ``dtype``; the patch frontend is
    refused as not yet ported."""
    check_trainable(cfg)
    bs = (shape.global_batch, shape.seq_len)
    out = {"tokens": ShapeDtype(bs, torch.int32),
           "labels": ShapeDtype(bs, torch.int32)}
    if cfg.encoder_decoder:
        out = {"frames": ShapeDtype(bs + (cfg.d_model,), dtype), **out}
    return out


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape,
                        dtype=torch.bfloat16) -> Dict[str, ShapeDtype]:
    """The train batch without labels; an encoder-decoder's encoder takes
    S frames and its decoder scores one BOS token (B, 1)."""
    spec = train_batch_specs(cfg, shape, dtype)
    del spec["labels"]
    if cfg.encoder_decoder:
        spec["tokens"] = ShapeDtype((shape.global_batch, 1), torch.int32)
    return spec


def decode_batch_specs(cfg: ModelConfig, shape: InputShape
                       ) -> Dict[str, ShapeDtype]:
    return {"tokens": ShapeDtype((shape.global_batch, 1), torch.int32),
            "t": ShapeDtype((), torch.int32)}


def abstract_decode_cache(cfg: ModelConfig, shape: InputShape,
                          dtype=torch.bfloat16) -> dict:
    """The decode cache's shapes: KV caches (an encoder-decoder's ``ck``
    / ``cv`` of ``seq_len`` encoder rows too) in the activation dtype,
    recurrent states (a mamba block's ``h`` and conv window, an xLSTM
    block's states) in f32."""
    cache_len = transformer.effective_cache_len(cfg, shape.seq_len)
    enc_len = shape.seq_len if cfg.encoder_decoder else 0
    specs = transformer.decode_cache_specs(cfg, shape.global_batch,
                                           cache_len, enc_len)
    return pt.tmap(lambda s: ShapeDtype(
        s.shape, dtype if "seq" in s.axes else torch.float32), specs)


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def step(params, batch):
        return transformer.prefill(params, batch, cfg)
    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def step(params, batch, cache):
        return transformer.decode_step(params, batch, cache, cfg)
    return step


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

def value_and_grad(lf: Callable, params):
    """``(lf(params), d lf / d params)`` by ``torch.autograd.grad`` on
    detached copies of the leaves: the loss detached, the gradient a new
    tree, ``params`` untouched."""
    leaves, treedef = pt.flatten(params)
    xs = [x.detach().requires_grad_(True) for x in leaves]
    loss = lf(pt.unflatten(treedef, xs))
    grads = torch.autograd.grad(loss, xs)
    return loss.detach(), pt.unflatten(treedef, list(grads))


def _dane_step(w, g, corr, anchor, eta: float, mu: float):
    """``w - eta (g + corr + mu (w - anchor))`` (Alg. 2 line 7, one SGD
    step), in the reference's order of tree ops."""
    dane_grad = pt.add(pt.add(g, corr), pt.scale(pt.sub(w, anchor), mu))
    return pt.sub(w, pt.scale(dane_grad, eta))


def make_feddane_round_step(cfg: ModelConfig, *, eta: float = 1e-3,
                            mu: float = 0.01, remat: str = "full"
                            ) -> Callable:
    """One FedDANE round participation (module docstring)."""
    check_trainable(cfg)

    def step(state, batch):
        lf = lambda p: transformer.loss_fn(p, batch, cfg, remat=remat)
        # phase A (Alg. 2 lines 5-6): the gradient at the server anchor
        _, g_anchor = value_and_grad(lf, state["anchor"])
        # the correction: server g_t against this client's anchor gradient
        corr = pt.sub(state["g_t"], g_anchor)
        # phase B (line 7): one step of the inexact DANE subproblem
        loss, g = value_and_grad(lf, state["params"])
        new_params = _dane_step(state["params"], g, corr, state["anchor"],
                                eta, mu)
        return ({"params": new_params, "anchor": new_params,
                 "g_t": g_anchor}, {"loss": loss})

    return step


def make_fedavg_step(cfg: ModelConfig, *, eta: float = 1e-3,
                     remat: str = "full") -> Callable:
    check_trainable(cfg)

    def step(state, batch):
        lf = lambda p: transformer.loss_fn(p, batch, cfg, remat=remat)
        loss, g = value_and_grad(lf, state["params"])
        return ({"params": pt.sub(state["params"], pt.scale(g, eta))},
                {"loss": loss})
    return step


def make_feddane_pipelined_step(cfg: ModelConfig, *, eta: float = 1e-3,
                                mu: float = 0.01, remat: str = "full"
                                ) -> Callable:
    """§V-C variant: the stale gradient correction, ONE forward and
    backward a round."""
    check_trainable(cfg)

    def step(state, batch):
        lf = lambda p: transformer.loss_fn(p, batch, cfg, remat=remat)
        loss, g = value_and_grad(lf, state["params"])
        corr = pt.sub(state["g_t"], g)        # stale server g_t vs current
        new_params = _dane_step(state["params"], g, corr, state["anchor"],
                                eta, mu)
        return ({"params": new_params, "anchor": new_params, "g_t": g},
                {"loss": loss})

    return step


STEP_BUILDERS = {
    "feddane": make_feddane_round_step,
    "fedavg": make_fedavg_step,
    "feddane_pipelined": make_feddane_pipelined_step,
}
