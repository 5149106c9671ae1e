"""Shared layers of the LM stack: RMSNorm, SwiGLU FFN, embeddings.

Counterpart of ``repro/models/layers.py`` (``rms_norm``, ``norm_spec``,
``swiglu_ffn(_specs)``, ``embed(_specs)``, ``unembed``, ``head(_specs)``).
Each layer is a function of ``(params_dict, inputs)`` over tensors, and
each spec builder returns the matching :class:`ParamSpec` tree, with the
reference's shapes and axis names.  Plain PyTorch on every device: the
reference computes these outside any Pallas kernel too.
"""
from __future__ import annotations

import torch

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
