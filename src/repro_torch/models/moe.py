"""Mixture-of-Experts layer: top-k router and group-local capacity dispatch.

Counterpart of ``repro/models/moe.py`` (``moe_specs``, ``_capacity``,
``group_capacity``, ``moe_ffn``), with its parameter tree (``router``
(d, E), ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d) and Arctic's
``dense`` SwiGLU branch) and its arithmetic:

- :func:`route`: the router's softmax, the top-k choices and their
  renormalised gates, and the Switch load-balance loss.  The choices
  follow ``jax.lax.top_k``: among equal probabilities the lower expert
  comes first.  ``torch.topk`` does not promise that, so the top k are
  the first k of a stable descending sort, on every device.
- :func:`slots`: each (token, choice) pair's slot in its expert's
  capacity block, from an exclusive count, in (token, choice) order, of
  the earlier pairs of the same sequence routed to the same expert.  A
  pair past the capacity ``Cb`` goes to the pad slot ``E * Cb``.
- :func:`moe_ffn`: the dispatch gather into each expert's (B*Cb, d)
  slot rows, the expert products (:func:`expert_matmul`, one ``bmm``
  over the experts, as the reference's einsums), and the combine: K
  gathers accumulated in f32 in choice order, then Arctic's dense
  residual branch.

The reference computes all of this outside any Pallas kernel, and so
does the port: plain PyTorch on every device.  The dispatch's
``scatter`` writes duplicate indices only into the pad column, which is
sliced off, so the arbitrary winner the card picks among duplicates
never shows.  Nothing is written in place and no value is read to the
host, so :func:`route` and :func:`moe_ffn` batch under
``torch.func.vmap`` (the trainer's ``vmap(grad)``) with no per-sample
fallback, at any capacity factor.

:func:`moe_ffn_plain` is a second, independent formulation of the same
function (a loop over the experts, without the slot arithmetic), for
the tests and ``chip_smoke.py`` to hold :func:`moe_ffn` against.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import swiglu_ffn, swiglu_ffn_specs
from repro_torch.models.param import ParamSpec

F32 = torch.float32


def moe_specs(d_model: int, d_ff: int, cfg: MoEConfig) -> dict:
    s = {
        "router": ParamSpec((d_model, cfg.num_experts),
                            ("d_model", None), scale=0.02),
        "w_gate": ParamSpec((cfg.num_experts, d_model, d_ff),
                            ("experts", "d_model", None)),
        "w_up": ParamSpec((cfg.num_experts, d_model, d_ff),
                          ("experts", "d_model", None)),
        "w_down": ParamSpec((cfg.num_experts, d_ff, d_model),
                            ("experts", None, "d_model")),
    }
    if cfg.dense_residual:
        s["dense"] = swiglu_ffn_specs(
            d_model, cfg.dense_residual_d_ff or d_ff)
    return s


def _capacity(num_tokens: int, cfg: MoEConfig,
              capacity_factor: float = 1.25) -> int:
    c = math.ceil(num_tokens * cfg.top_k / cfg.num_experts * capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def group_capacity(seq_len: int, cfg: MoEConfig,
                   capacity_factor: float = 1.25) -> int:
    """Per-group (= per-sequence) expert capacity (Switch-style)."""
    return _capacity(seq_len, cfg, capacity_factor)


class Routing(NamedTuple):
    probs: torch.Tensor   # (B, S, E) f32 router softmax
    gate: torch.Tensor    # (B, S, K) f32 gates of the choices, summing to 1
    idx: torch.Tensor     # (B, S, K) int64 experts, jax.lax.top_k's order
    aux: torch.Tensor     # () f32 Switch load-balance loss


def top_k(probs, k: int):
    """``jax.lax.top_k`` along the last dim: the k largest values in
    descending order, the lower index first among equal values."""
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def route(params, x, cfg: MoEConfig) -> Routing:
    """The router on ``x`` (B, S, d) and the load-balance loss."""
    logits = (x @ params["router"]).to(F32)
    probs = torch.softmax(logits, dim=-1)
    return choose(probs, top_k(probs, cfg.top_k)[1], cfg)


def choose(probs, idx, cfg: MoEConfig) -> Routing:
    """The routing of the choices ``idx`` (B, S, K) under the router's
    softmax ``probs`` (B, S, E): their gates renormalised to sum to 1,
    and the load-balance loss."""
    E = cfg.num_experts
    gate = torch.gather(probs, -1, idx)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))                                 # (E,)
    # the share of the choices on each expert; a comparison rather than
    # ``F.one_hot``, whose check of the range reads a value to the host
    # (which ``torch.func.vmap`` refuses)
    hits = idx[..., None] == torch.arange(E, device=idx.device)
    ce = hits.to(F32).mean(dim=(0, 1, 2))
    aux = cfg.aux_loss_weight * E * torch.sum(me * ce)
    return Routing(probs, gate, idx, aux)


def slots(idx, num_experts: int, capacity: int):
    """(B, S*K) slot of every (token, choice) pair of ``idx`` (B, S, K):
    ``expert * capacity + position``, its position the number of earlier
    pairs of its sequence on the same expert; ``num_experts * capacity``
    (the pad slot) where that is ``capacity`` or more."""
    B, S, K = idx.shape
    ge = idx.reshape(B, S * K)
    experts = torch.arange(num_experts, device=idx.device)
    # the one-hot held (B, E, SK), so that the count runs along the
    # innermost dim (the card scans a strided dim one thread a column);
    # the inclusive count at the pair's own expert, less the pair
    onehot = (experts[:, None] == ge[:, None, :]).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, dim=2, dtype=torch.int32), 1,
                       ge[:, None, :])[:, 0] - 1
    return torch.where(pos < capacity, ge * capacity + pos,
                       num_experts * capacity)


class _ExpertMatmul(torch.autograd.Function):
    """``torch.bmm`` over the experts, (E, R, m) @ (E, m, n) -> (E, R, n),
    whose ``vmap`` takes the mapped dim of the rows' operand into its
    rows: one product against the unmapped weights, which functorch's own
    rule would copy once a client (``matmul`` broadcasts them).  Mapped
    weights fold into the expert dim.  Its backward is the same
    function, so that the gradients fold alike."""

    @staticmethod
    def forward(x, w):
        return torch.bmm(x, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (_ExpertMatmul.apply(g, w.transpose(1, 2)),
                _ExpertMatmul.apply(x.transpose(1, 2), g))

    @staticmethod
    def vmap(info, in_dims, x, w):
        xd, wd = in_dims
        if wd is None:
            xs = x.movedim(xd, 1)                          # (E, N, R, m)
            E, N, R, m = xs.shape
            out = _ExpertMatmul.apply(xs.reshape(E, N * R, m), w)
            return out.reshape(E, N, R, -1), 1
        w = w.movedim(wd, 0)                               # (N, E, m, n)
        N, E = w.shape[:2]
        x = (x.movedim(xd, 0) if xd is not None
             else x.expand((N,) + x.shape))
        out = _ExpertMatmul.apply(x.reshape((N * E,) + x.shape[2:]),
                                  w.reshape((N * E,) + w.shape[2:]))
        return out.reshape((N, E) + out.shape[1:]), 0


def expert_matmul(x, w):
    """(E, R, m) @ (E, m, n) -> (E, R, n), one product an expert
    (:class:`_ExpertMatmul`)."""
    return _ExpertMatmul.apply(x, w)


def moe_ffn(params, x, cfg: MoEConfig,
            capacity_factor: float = 1.25) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss ()).

    Each sequence is a routing group with expert capacity ``Cb``
    (:func:`group_capacity`); its pairs are gathered into ``E * Cb``
    slots, run through the experts as one batched product a weight, and
    combined back with the gates.
    """
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    Cb = group_capacity(S, cfg, capacity_factor)
    r = route(params, x, cfg)
    slot = slots(r.idx, E, Cb)                                  # (B, SK)

    # the token position of each slot; S (the zero row) where it is empty
    s_idx = torch.arange(S, device=x.device).repeat_interleave(K)
    disp = torch.full((B, E * Cb + 1), S, dtype=torch.long, device=x.device)
    disp = disp.scatter(1, slot, s_idx.expand(B, S * K))[:, :E * Cb]
    rows = torch.arange(B, device=x.device)[:, None]
    xpad = torch.cat([x, x.new_zeros(B, 1, d)], dim=1)
    # each expert's slot rows of every sequence, (E, B*Cb, d)
    xe = xpad[rows, disp].reshape(B, E, Cb, d).transpose(0, 1).reshape(
        E, B * Cb, d)

    g = expert_matmul(xe, params["w_gate"])
    u = expert_matmul(xe, params["w_up"])
    h = F.silu(g) * u
    ye = expert_matmul(h, params["w_down"]).reshape(E, B, Cb, d).transpose(
        0, 1)                                                  # (B,E,Cb,d)

    # combine: K gathers, summed in f32 in choice order
    ypad = torch.cat([ye.reshape(B, E * Cb, d), ye.new_zeros(B, 1, d)],
                     dim=1)
    slot3 = slot.reshape(B, S, K)
    out = None
    for j in range(K):
        term = ypad[rows, slot3[:, :, j]].to(F32) \
            * r.gate[:, :, j, None].to(F32)
        out = term if out is None else out + term

    if cfg.dense_residual:
        out = out + swiglu_ffn(params["dense"], x).to(F32)
    return out.to(x.dtype), r.aux


def moe_ffn_plain(params, x, cfg: MoEConfig,
                  capacity_factor: float = 1.25) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """:func:`moe_ffn` written another way, for comparison only: for
    each sequence and expert, the pairs routed to the expert in (token,
    choice) order, the first ``Cb`` of them through its SwiGLU, scaled by
    their gates; each token's K results summed in choice order.  The
    load-balance loss from the counts of the choices."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    Cb = group_capacity(S, cfg, capacity_factor)
    r = route(params, x, cfg)
    parts = x.new_zeros((B, S, K, d), dtype=F32)
    for b in range(B):
        flat = r.idx[b].reshape(S * K)
        for e in range(E):
            pairs = torch.nonzero(flat == e)[:Cb, 0]
            if pairs.numel() == 0:
                continue
            s, k = pairs // K, pairs % K
            expert = {w: params[w][e] for w in ("w_gate", "w_up", "w_down")}
            y = swiglu_ffn(expert, x[b, s]).to(F32)
            parts[b, s, k] = y * r.gate[b, s, k, None]
    out = parts[:, :, 0]
    for j in range(1, K):
        out = out + parts[:, :, j]
    if cfg.dense_residual:
        out = out + swiglu_ffn(params["dense"], x).to(F32)
    counts = torch.bincount(r.idx.reshape(-1), minlength=E).to(F32)
    aux = cfg.aux_loss_weight * E * torch.sum(
        r.probs.mean(dim=(0, 1)) * counts / r.idx.numel())
    return out.to(x.dtype), aux
