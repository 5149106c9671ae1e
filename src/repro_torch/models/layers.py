"""Shared layers of the LM stack: RMSNorm, SwiGLU FFN, embeddings and
the chunked cross-entropy.

Counterpart of ``repro/models/layers.py`` (``rms_norm``, ``norm_spec``,
``swiglu_ffn(_specs)``, ``gelu_mlp(_specs)``, ``embed(_specs)``,
``unembed``, ``head(_specs)``, ``chunked_softmax_xent``).
Each layer is a function of ``(params_dict, inputs)`` over tensors, and
each spec builder returns the matching :class:`ParamSpec` tree, with the
reference's shapes and axis names.  Plain PyTorch on every device: the
reference computes these outside any Pallas kernel too.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.param import ParamSpec

F32 = torch.float32


def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.to(F32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(F32)).to(dtype)


def norm_spec(d_model: int) -> ParamSpec:
    return ParamSpec((d_model,), ("d_model",), init="ones")


def swiglu_ffn_specs(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("d_model", "d_ff")),
        "w_up": ParamSpec((d_model, d_ff), ("d_model", "d_ff")),
        "w_down": ParamSpec((d_ff, d_model), ("d_ff", "d_model")),
    }


def swiglu_ffn(params, x):
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    return (torch.nn.functional.silu(gate) * up) @ params["w_down"]


def gelu_mlp_specs(d_model: int, d_ff: int) -> dict:
    """The encoder-decoder FFN (whisper): biased in/out projections."""
    return {
        "w_in": ParamSpec((d_model, d_ff), ("d_model", "d_ff")),
        "b_in": ParamSpec((d_ff,), ("d_ff",), init="zeros"),
        "w_out": ParamSpec((d_ff, d_model), ("d_ff", "d_model")),
        "b_out": ParamSpec((d_model,), ("d_model",), init="zeros"),
    }


def gelu_mlp(params, x):
    h = x @ params["w_in"] + params["b_in"]
    # jax.nn.gelu's default is the tanh approximation, not the exact erf
    # form that F.gelu takes by default
    h = torch.nn.functional.gelu(h, approximate="tanh")
    return h @ params["w_out"] + params["b_out"]


def embed_specs(vocab: int, d_model: int) -> dict:
    return {"embedding": ParamSpec((vocab, d_model), ("vocab", "d_model"),
                                   init="embed")}


def embed(params, token_ids):
    return params["embedding"][token_ids.long()]


def unembed(params, x):
    """Logits from hidden states through the tied ``(V, d)`` embedding."""
    return x @ params["embedding"].T


def head_specs(d_model: int, vocab: int) -> dict:
    return {"w": ParamSpec((d_model, vocab), ("d_model", "vocab"))}


def head(params, x):
    return x @ params["w"]


# ---------------------------------------------------------------------------
# Cross-entropy, chunked over the sequence so full logits are never resident.
# ---------------------------------------------------------------------------

def _xent_chunk(hidden, w_or_emb, labels, transpose: bool):
    """Summed token cross-entropy of one chunk and its count of labels
    that are not -1, both f32 scalars."""
    logits = hidden @ (w_or_emb.T if transpose else w_or_emb)
    logits = logits.to(F32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(F32)
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_softmax_xent(hidden, w_or_emb, labels, *, transpose: bool,
                         chunk: int = 512, remat: bool = True):
    """Mean token cross-entropy with seq-chunked logit materialisation.

    ``hidden``: (B, S, d); ``w_or_emb``: the tied ``(V, d)`` embedding
    (``transpose``) or the ``(d, V)`` head; ``labels``: (B, S) with -1 =
    ignore.  As in the reference, one chunk when ``S % chunk`` or
    ``S <= chunk``; else the chunks' sums add up in f32, in order.  With
    ``remat`` each chunk is checkpointed (``torch.utils.checkpoint``), so
    the backward keeps one (B, chunk, V) logits block at a time; the
    reference always rematerialises, but ``torch.func.grad`` refuses
    checkpoints, so the trainer's loss passes ``remat=False``.
    """
    B, S, _ = hidden.shape
    if S % chunk != 0 or S <= chunk:
        loss, denom = _xent_chunk(hidden, w_or_emb, labels, transpose)
        return loss / torch.clamp(denom, min=1.0)
    loss = denom = None
    for c0 in range(0, S, chunk):
        args = (hidden[:, c0:c0 + chunk], w_or_emb, labels[:, c0:c0 + chunk],
                transpose)
        l, n = (checkpoint(_xent_chunk, *args, use_reentrant=False) if remat
                else _xent_chunk(*args))
        loss, denom = (l, n) if loss is None else (loss + l, denom + n)
    return loss / torch.clamp(denom, min=1.0)
