"""GQA attention with RoPE: the K7 route, full, chunked and cached.

Counterpart of ``repro/models/attention.py``.  Layouts are the
reference's: q (B, S, H, hd), k/v (B, T, Kv, hd), query head
``h = g * Kv + n`` reading KV head ``n`` (``_group``, tile order).

- ``attention`` is the self-attention of prefill and of the training
  loss.  On the card it runs the hand-written kernel K7
  (``kernels/flash_attention.py``) through :func:`flash_gqa`, at any
  length, and under autograd K7's backward kernel (the fold's permutes
  and reshapes carry the gradient and ``vmap`` through); on the CPU it
  takes
  :func:`plain_attention`, the reference's dispatch to the plain
  ``full_attention`` or ``chunked_attention`` by its ``CHUNK_THRESHOLD``
  and chunk rule.  Nothing falls back to the plain versions on the card.
- ``full_attention`` (materialised scores) and ``chunked_attention`` (the
  online-softmax recurrence over KV chunks) are the plain versions.
- ``cached_attention`` and ``update_cache`` are the decode path: one query
  row against the ring-buffer KV cache, plain PyTorch on every device.

The reference's sharding constraints (``models/shardutil.py``) and its
tensor-parallel KV repeat (``_maybe_repeat_kv``) are identities off a
mesh; the port has no tensor-parallel axis yet and leaves them out.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_3d
from repro_torch.models.param import ParamSpec

CHUNK_THRESHOLD = 4096
KV_CHUNK = 512
NEG_INF = -1e30
F32 = torch.float32


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return theta ** -exps


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].to(F32) * freqs              # (..., S, hd/2)
    angles = angles[..., None, :]                              # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def attention_specs(d_model: int, num_heads: int, num_kv_heads: int,
                    head_dim: int, qkv_bias: bool = False) -> dict:
    s = {
        "wq": ParamSpec((d_model, num_heads, head_dim),
                        ("d_model", "heads", "head_dim")),
        "wk": ParamSpec((d_model, num_kv_heads, head_dim),
                        ("d_model", "kv_heads", "head_dim")),
        "wv": ParamSpec((d_model, num_kv_heads, head_dim),
                        ("d_model", "kv_heads", "head_dim")),
        "wo": ParamSpec((num_heads, head_dim, d_model),
                        ("heads", "head_dim", "d_model")),
    }
    if qkv_bias:
        s["bq"] = ParamSpec((num_heads, head_dim), ("heads", "head_dim"),
                            init="zeros")
        s["bk"] = ParamSpec((num_kv_heads, head_dim),
                            ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = ParamSpec((num_kv_heads, head_dim),
                            ("kv_heads", "head_dim"), init="zeros")
    return s


def _project(x, w):
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def qkv_project(params, x, positions, theta: float):
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def out_project(params, o):
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    h, k, d = params["wo"].shape
    return o.flatten(-2) @ params["wo"].reshape(h * k, d)


def _group(q, num_kv_heads: int):
    """(B,S,H,hd) -> (B,S,G,Kv,hd) with h = g*Kv + n."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, H // num_kv_heads, num_kv_heads, hd)


# ---------------------------------------------------------------------------
# The K7 route (the card)
# ---------------------------------------------------------------------------

def flash_gqa(q, k, v, *, causal: bool):
    """Self-attention through K7 with the model's head order.

    q: (B,S,H,hd); k, v: (B,T,Kv,hd) -> (B,S,H,hd).  The G = H/Kv query
    heads that share KV head n (heads g*Kv + n) become G*S query rows of
    one (B*Kv) slice: (B,S,G,Kv,hd) -> (B,Kv,G,S,hd) -> (B*Kv, G*S, hd),
    against (B*Kv, T, hd) keys and values that are never repeated; row
    g*S + s sits at sequence position s (``causal_period=S``).
    """
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    q3 = _group(q, Kv).permute(0, 3, 2, 1, 4).reshape(B * Kv, G * S, hd)
    k3 = k.permute(0, 2, 1, 3).reshape(B * Kv, T, hd)
    v3 = v.permute(0, 2, 1, 3).reshape(B * Kv, T, hd)
    o = flash_attention_3d(q3, k3, v3, causal=causal, causal_period=S)
    return o.reshape(B, Kv, G, S, hd).permute(0, 3, 2, 1, 4) \
        .reshape(B, S, H, hd)


# ---------------------------------------------------------------------------
# Plain versions: full attention (short sequences), chunked (long)
# ---------------------------------------------------------------------------

def _mask(sq: int, positions_k, *, causal: bool, window: int,
          q_offset: int, device):
    qpos = torch.arange(sq, device=device) + q_offset
    mask = torch.ones((sq, positions_k.shape[0]), dtype=torch.bool,
                      device=device)
    if causal:
        mask &= positions_k[None, :] <= qpos[:, None]
    if window:
        mask &= positions_k[None, :] > qpos[:, None] - window
    return mask


def full_attention(q, k, v, *, causal: bool, window: int = 0,
                   q_offset: int = 0):
    """q: (B,Sq,H,hd); k,v: (B,Skv,Kv,hd).  Returns (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    Kv = k.shape[2]
    qg = _group(q, Kv)
    scores = torch.einsum("bsgnk,btnk->bgnst", qg.to(F32) * hd ** -0.5,
                          k.to(F32))
    mask = _mask(Sq, torch.arange(k.shape[1], device=q.device),
                 causal=causal, window=window, q_offset=q_offset,
                 device=q.device)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bgnst,btnk->bsgnk", probs.to(v.dtype), v)
    return o.reshape(B, Sq, H, hd)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      kv_chunk: int = KV_CHUNK):
    """The flash-attention recurrence over KV chunks; O(Sq * chunk)
    memory for the scores."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    if Skv % kv_chunk != 0:
        return full_attention(q, k, v, causal=causal, window=window)
    G = H // Kv
    qg = (_group(q, Kv) * hd ** -0.5).to(F32)
    m = torch.full((B, G, Kv, Sq), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((B, G, Kv, Sq), dtype=F32, device=q.device)
    acc = torch.zeros((B, G, Kv, Sq, hd), dtype=F32, device=q.device)
    for c0 in range(0, Skv, kv_chunk):
        kb = k[:, c0:c0 + kv_chunk].to(F32)
        vb = v[:, c0:c0 + kv_chunk].to(F32)
        kpos = torch.arange(c0, c0 + kv_chunk, device=q.device)
        s = torch.einsum("bsgnk,btnk->bgnst", qg, kb)
        mask = _mask(Sq, kpos, causal=causal, window=window, q_offset=0,
                     device=q.device)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully-masked chunks: keep p exactly 0 (avoid exp(-inf - -inf) = 1)
        p = torch.exp(s - m_new[..., None]) * mask.to(F32)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bgnst,btnk->bgnsk", p,
                                                   vb)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return o.to(q.dtype)


def plain_attention(q, k, v, *, causal: bool, window: int = 0):
    """The reference's ``attention``: full attention below
    ``CHUNK_THRESHOLD`` query rows, chunked from it on."""
    S = q.shape[1]
    if S >= CHUNK_THRESHOLD:
        chunk = max(KV_CHUNK, min(1024, S // 4))
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 kv_chunk=chunk)
    return full_attention(q, k, v, causal=causal, window=window)


def attention(q, k, v, *, causal: bool, window: int = 0):
    """Self-attention of prefill and training: K7 (and its backward) on
    the card, the plain versions on the CPU."""
    if q.device.type == "cuda":
        if window:
            raise ValueError("attention: K7 takes no sliding window; the "
                             "windowed prefill is not yet ported")
        return flash_gqa(q, k, v, causal=causal)
    return plain_attention(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# Decode: one new token against a KV cache
# ---------------------------------------------------------------------------

def cached_attention(q, k_cache, v_cache, *, cache_len):
    """q: (B,1,H,hd); caches: (B,S,Kv,hd); cache_len: an int or a (B,)
    tensor of valid lengths."""
    B, _, H, hd = q.shape
    Kv = k_cache.shape[2]
    qg = _group(q, Kv).to(F32) * hd ** -0.5
    s = torch.einsum("bsgnk,btnk->bgnst", qg, k_cache.to(F32))
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    valid = kpos[None, :] < torch.as_tensor(
        cache_len, device=q.device).reshape(-1, 1)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    o = torch.einsum("bgnst,btnk->bsgnk", probs, v_cache.to(F32))
    return o.reshape(B, 1, H, hd).to(q.dtype)


def update_cache(k_cache, v_cache, k_new, v_new, position):
    """Insert one token at ``position`` (an int) into the ring/linear
    cache, in place: the reference returns updated copies, the port
    writes the slot and returns the same tensors."""
    pos = int(position) % k_cache.shape[1]
    k_cache[:, pos:pos + 1] = k_new.to(k_cache.dtype)
    v_cache[:, pos:pos + 1] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
