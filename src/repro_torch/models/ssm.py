"""Mamba SSM mixer (Jamba's recurrent block) and the chunked-scan helper.

Counterpart of ``repro/models/ssm.py``, with its parameter tree
(``mamba_specs``), projections, depthwise causal conv and step:

- :func:`chunked_scan`: ``lax.scan`` of a step over the leading axis,
  as a Python loop, cut into the reference's chunks (the same three
  cases: S <= chunk, S % chunk != 0, chunked).  Its forward is the
  reference's in every case, and autograd differentiates through it
  (keeping every step's tensors).  The reference's per-chunk
  ``jax.checkpoint`` is not a ``torch.utils.checkpoint`` here:
  ``torch.func.grad``, the trainer's ``vmap(grad)``, refuses
  saved-tensor hooks.  On the card that remat lives in K8's Function,
  which saves only the chunk-boundary states ``H`` for K8-bwd.
- :func:`selective_scan`: the recurrence ``h_t = exp(dt_t A) h_{t-1} +
  (dt_t x_t) b_t``, ``y_t = h_t c_t`` from ``h = 0`` -- on the card the
  hand-written kernel K8 and its backward K8-bwd
  (``kernels/selective_scan.py``, differentiable and vmappable), on the
  CPU :func:`plain_scan`, ``chunked_scan`` of the reference's step
  (bitwise the reference's order; autograd differentiates it).
  :func:`mamba_mixer` looks it up at call time, so a comparison run can
  swap in :func:`plain_scan` on the card (as ``attention.attention`` is
  swapped for the plain attention).
- :func:`mamba_decode_step`: one step of the same recurrence on the
  decode cache's ``h`` and conv window, plain PyTorch on every device;
  it writes both into the cache in place (the reference returns new
  ones), as the KV cache is written.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import pytree as pt
from repro_torch.device import resolve_device
from repro_torch.kernels.selective_scan import \
    selective_scan as selective_scan_kernel
from repro_torch.models.param import ParamSpec

SCAN_CHUNK = 64
F32 = torch.float32


def _scan(step: Callable, carry, xs, start: int, stop: int, ys: list):
    for t in range(start, stop):
        carry, y = step(carry, pt.index(xs, t))
        ys.append(y)
    return carry


def chunked_scan(step: Callable, carry, xs, chunk: int = SCAN_CHUNK):
    """Scan ``step`` (``(carry, x_t) -> (carry, y_t)``) over the leading
    axis of the tree ``xs``; returns ``(carry, ys)``, ``ys`` the step
    outputs stacked along a new leading axis.  No chunk is checkpointed
    (``torch.func.grad`` refuses checkpoints): on the card the
    reference's per-chunk remat is K8's saved ``H`` (module docstring)."""
    S = pt.leaves(xs)[0].shape[0]
    ys: list = []
    if S <= chunk or S % chunk != 0:
        carry = _scan(step, carry, xs, 0, S, ys)
    else:
        for c0 in range(0, S, chunk):
            carry = _scan(step, carry, xs, c0, c0 + chunk, ys)
    return carry, pt.stack(ys)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return d_inner, dt_rank, cfg.ssm_state_dim


def mamba_specs(cfg: ModelConfig) -> dict:
    d_inner, dt_rank, N = mamba_dims(cfg)
    d = cfg.d_model
    return {
        "w_in": ParamSpec((d, 2 * d_inner), ("d_model", "ssm_inner")),
        "conv_w": ParamSpec((cfg.ssm_conv_dim, d_inner),
                            ("conv", "ssm_inner"), scale=0.1),
        "conv_b": ParamSpec((d_inner,), ("ssm_inner",), init="zeros"),
        "w_x": ParamSpec((d_inner, dt_rank + 2 * N), ("ssm_inner", None)),
        "w_dt": ParamSpec((dt_rank, d_inner), (None, "ssm_inner")),
        "b_dt": ParamSpec((d_inner,), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((d_inner, N), ("ssm_inner", "ssm_state"),
                           init="zeros"),
        "d_skip": ParamSpec((d_inner,), ("ssm_inner",), init="ones"),
        "w_out": ParamSpec((d_inner, d), ("ssm_inner", "d_model")),
    }


def _mamba_inputs(params, x, cfg: ModelConfig, conv_state=None):
    """Shared projections.  x: (B, S, d) -> the scan's inputs ``xs``,
    ``dt`` (B, S, di), ``Bc``, ``Cc`` (B, S, N), ``A`` (di, N) f32, the
    gate ``z`` and the new conv window (B, Kc-1, di)."""
    d_inner, dt_rank, N = mamba_dims(cfg)
    xz = x @ params["w_in"]
    xs, z = xz[..., :d_inner], xz[..., d_inner:]

    # depthwise causal conv over seq, kernel ssm_conv_dim: the sum of the
    # Kc shifted slices in order j = 0..Kc-1, as the reference writes it
    Kc = cfg.ssm_conv_dim
    state_dtype = xs.dtype if conv_state is None else conv_state.dtype
    if conv_state is None:
        pad = xs.new_zeros(xs.shape[:1] + (Kc - 1,) + xs.shape[2:])
    else:
        pad = conv_state.to(xs.dtype)                       # (B, Kc-1, di)
    xpad = torch.cat([pad, xs], dim=1)
    S = xs.shape[1]
    conv = xpad[:, 0:S] * params["conv_w"][0]
    for j in range(1, Kc):
        conv = conv + xpad[:, j:j + S] * params["conv_w"][j]
    new_conv_state = xpad[:, xpad.shape[1] - (Kc - 1):].to(state_dtype)
    xs = F.silu(conv + params["conv_b"])

    proj = xs @ params["w_x"]
    dt_low = proj[..., :dt_rank]
    Bc = proj[..., dt_rank:dt_rank + N]
    Cc = proj[..., dt_rank + N:]
    dt = F.softplus(dt_low @ params["w_dt"] + params["b_dt"])
    A = -torch.exp(params["a_log"].to(F32))                 # (di, N), < 0
    return xs, z, dt, Bc, Cc, A, new_conv_state


def _mamba_step(A):
    def step(h, xs_t):
        x_t, dt_t, b_t, c_t = xs_t                  # (B,di),(B,di),(B,N),(B,N)
        da = torch.exp(dt_t.to(F32)[..., None] * A)             # (B,di,N)
        dbx = (dt_t * x_t).to(F32)[..., None] \
            * b_t.to(F32)[:, None, :]                           # (B,di,N)
        h = da * h + dbx
        y = torch.einsum("bin,bn->bi", h, c_t.to(F32))
        return h, y
    return step


def plain_scan(xs, dt, Bc, Cc, A, chunk: int = SCAN_CHUNK):
    """The scan as the reference runs it: ``chunked_scan`` of
    ``_mamba_step`` from ``h = 0`` over the sequence.  (B, S, di) f32."""
    B, _, d_inner = xs.shape
    h0 = xs.new_zeros((B, d_inner, A.shape[1]), dtype=F32)
    swap = lambda a: a.transpose(0, 1)                      # (S,B,...)
    _, ys = chunked_scan(_mamba_step(A), h0,
                         (swap(xs), swap(dt), swap(Bc), swap(Cc)), chunk)
    return ys.transpose(0, 1)


def selective_scan(xs, dt, Bc, Cc, A, chunk: int = SCAN_CHUNK):
    """The scan of the prefill and of training: K8 (with K8-bwd under
    grad) on the card, :func:`plain_scan` on the CPU.  (B, S, di) f32."""
    if xs.device.type == "cuda":
        return selective_scan_kernel(xs, dt, Bc, Cc, A)
    return plain_scan(xs, dt, Bc, Cc, A, chunk)


def mamba_mixer(params, x, cfg: ModelConfig, chunk: int = SCAN_CHUNK):
    """Training/prefill forward.  x: (B,S,d) -> (B,S,d)."""
    xs, z, dt, Bc, Cc, A, _ = _mamba_inputs(params, x, cfg)
    y = selective_scan(xs, dt, Bc, Cc, A, chunk).to(x.dtype)  # (B,S,di)
    y = y + xs * params["d_skip"]
    y = y * F.silu(z)
    return y @ params["w_out"]


def mamba_init_state(cfg: ModelConfig, batch: int, dtype=F32,
                     device=None):
    """The decode state on ``device`` (the card unless ``"cpu"``): ``h``
    (B, di, N) in f32 whatever ``dtype``, and the conv window (B, Kc-1,
    di) in ``dtype``, zeros."""
    d_inner, _, N = mamba_dims(cfg)
    device = resolve_device(device)
    return {
        "h": torch.zeros((batch, d_inner, N), dtype=F32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_dim - 1, d_inner),
                            dtype=dtype, device=device),
    }


def mamba_decode_step(params, x, state, cfg: ModelConfig):
    """x: (B,1,d); state: {h, conv} -> (y (B,1,d), state): one step of
    the recurrence, with ``state["h"]`` and ``state["conv"]`` written in
    place (the reference returns new ones)."""
    xs, z, dt, Bc, Cc, A, conv_state = _mamba_inputs(
        params, x, cfg, conv_state=state["conv"])
    h, y = _mamba_step(A)(state["h"].to(F32),
                          (xs[:, 0], dt[:, 0], Bc[:, 0], Cc[:, 0]))
    y = y[:, None].to(x.dtype) + xs * params["d_skip"]
    y = y * F.silu(z)
    out = y @ params["w_out"]
    state["h"].copy_(h)
    state["conv"].copy_(conv_state)
    return out, state
