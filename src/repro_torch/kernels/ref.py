"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, op by op, in f32.
The kernel wrappers take these only for tensors that lie on the CPU;
the CPU tests run them against the JAX reference, and ``chip_smoke.py``
holds each kernel against its plain version on the card.  Nothing on
the main path calls them for tensors on the card.
"""
from __future__ import annotations

import torch

F32 = torch.float32
#: The reference's mask value for an invisible key's score.
NEG_INF = -1e30


def dane_update_ref(w, grad, g_corr, anchor, *, eta: float, mu: float):
    """FedDANE local step (Alg. 2 line 7, one SGD step), K4's function:

        w' = w - eta * (grad + g_corr + mu * (w - anchor))

    computed in f32 and cast back to ``w``'s dtype.
    """
    wf = w.to(F32)
    out = wf - eta * (grad.to(F32) + g_corr.to(F32)
                      + mu * (wf - anchor.to(F32)))
    return out.to(w.dtype)


def dane_update_flat_ref(w, grad, g_corr, anchor, eta: float, mu: float,
                         mask, rows_per_dev: int):
    """K1's function: the update over a ``(K*rows_per_dev, 128)`` flat
    pack, where rows of devices whose ``(K,)`` mask is not > 0 keep
    ``w`` exactly."""
    out = dane_update_ref(w, grad, g_corr, anchor, eta=eta, mu=mu)
    keep = (mask.to(F32) > 0).repeat_interleave(rows_per_dev)[:, None]
    return torch.where(keep, out, w)


def dane_update_leaves_ref(w_leaves, g_leaves, c_leaves, a_leaves,
                           eta: float, mu: float, mask=None):
    """The per_leaf step's function (``dane_update_leaves``): the update
    per leaf, then, with a ``(K,)`` ``mask`` over the leaves' leading
    axis, the select -- a device whose mask is not > 0 keeps ``w``."""
    outs = [dane_update_ref(w, g, c, a, eta=eta, mu=mu)
            for w, g, c, a in zip(w_leaves, g_leaves, c_leaves, a_leaves)]
    if mask is None:
        return outs
    keep = mask.to(F32) > 0
    return [torch.where(keep.reshape(keep.shape + (1,) * (o.dim() - 1)),
                        o, w) for o, w in zip(outs, w_leaves)]


def _softmax_residual(x, y, w, b, batch_total: int):
    """K-batched softmax-regression gradient pieces in the kernels'
    order: logits, max-subtract, exp, normalise, ``(p - onehot)/B``,
    then ``Xᵀr`` and ``Σr``.

    ``x``: (K, rows, d); ``y``: (K, rows) int; ``w``: (K, d, C);
    ``b``: (K, C).  Returns ``(gw (K, d, C), gb (K, C))``.
    """
    logits = torch.bmm(x, w) + b[:, None, :]
    zmax = logits.amax(dim=-1, keepdim=True)
    ez = torch.exp(logits - zmax)
    p = ez / ez.sum(dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(y.long(), w.shape[-1]).to(F32)
    r = (p - onehot) / batch_total
    return torch.bmm(x.transpose(1, 2), r), r.sum(dim=1)


def _sgd_prox(w, g, c, w0, eta: float, mu: float):
    return w - eta * (g + c + mu * (w - w0))


def linear_logistic_step_ref(w, batch, corr, w0, *, eta: float, mu: float,
                             mask):
    """K3's function: one masked SGD step of K stacked softmax
    regressions.  ``w``/``corr``: ``{"w": (K, d, C), "b": (K, C)}``;
    ``batch``: ``{"x": (K, B, d), "y": (K, B)}``; ``w0``: the unstacked
    anchor; ``mask``: (K,), devices not > 0 keep ``w`` exactly."""
    x = batch["x"].to(F32)
    ww, bb = w["w"].to(F32), w["b"].to(F32)
    gw, gb = _softmax_residual(x, batch["y"], ww, bb, x.shape[1])
    wn = _sgd_prox(ww, gw, corr["w"].to(F32), w0["w"].to(F32), eta, mu)
    bn = _sgd_prox(bb, gb, corr["b"].to(F32), w0["b"].to(F32), eta, mu)
    keep = mask.to(F32) > 0
    return {"w": torch.where(keep[:, None, None], wn, ww),
            "b": torch.where(keep[:, None], bn, bb)}


def local_epoch_ref(w0, corr, batches, *, eta: float, mu: float,
                    num_epochs: int, step_mask):
    """K2's function: a whole E-epoch solve of K stacked softmax
    regressions from the shared anchor ``w0``.  ``batches``:
    ``{"x": (K, nb, B, d), "y": (K, nb, B)}``; step ``t`` uses batch
    ``t % nb`` and is kept where ``step_mask[:, t] > 0``."""
    x = batches["x"].to(F32)
    K, nb, B, d = x.shape
    a_w, a_b = w0["w"].to(F32), w0["b"].to(F32)
    w = {"w": a_w.expand((K,) + a_w.shape).clone(),
         "b": a_b.expand((K,) + a_b.shape).clone()}
    for t in range(num_epochs * nb):
        j = t % nb
        w = linear_logistic_step_ref(
            w, {"x": x[:, j], "y": batches["y"][:, j]}, corr, w0,
            eta=eta, mu=mu, mask=step_mask[:, t])
    return w


def _mask_count(m):
    """``sum_k m_k`` added k = 0..K-1, as the codec kernels count."""
    cnt = torch.zeros((), dtype=F32, device=m.device)
    for k in range(m.shape[0]):
        cnt = cnt + m[k]
    return cnt


def codec_aggregate_partial_ref(vals, scales, mask):
    """K6's function: the dequantized masked cohort sum

        out = sum_k m_k * s_k * v_k

    over ``vals`` (K, rows, 128) with ``scales``/``mask`` (K,), in the
    kernel's order: ``acc + v_k * w_k`` with ``w_k = s_k * m_k`` over
    the clients with ``m_k != 0`` in order (a masked client adds
    nothing, and is never read).  An all-inactive cohort gives +0.0.
    """
    m = mask.to(F32)
    w = scales.to(F32) * m
    acc = torch.zeros(vals.shape[1:], dtype=F32, device=vals.device)
    for k in torch.nonzero(m).flatten().tolist():
        acc = acc + vals[k].to(F32) * w[k]
    return acc


def codec_aggregate_ref(vals, scales, mask):
    """K5's function: the dequantized masked cohort mean

        out = sum_k m_k * s_k * v_k / max(sum_k m_k, 1)

    in the kernel's order: the count summed k = 0..K-1, K6's sum, then
    one division.  An all-inactive cohort gives zeros.
    """
    cnt = _mask_count(mask.to(F32))
    return (codec_aggregate_partial_ref(vals, scales, mask)
            / torch.clamp(cnt, min=1.0))


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Materialised-scores attention, the reference's oracle
    (``repro/kernels/ref.py:66``).  q, k, v: (B, H, S|T, hd)."""
    S, hd = q.shape[2], q.shape[3]
    T = k.shape[2]
    scores = torch.einsum("bhsk,bhtk->bhst", q.to(F32) * hd ** -0.5,
                          k.to(F32))
    if causal:
        dev = q.device
        mask = (torch.arange(T, device=dev)[None, :]
                <= torch.arange(S, device=dev)[:, None])
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bhtk->bhsk", probs, v.to(F32))
    return out.to(q.dtype)


def _scores_3d(q, k, causal: bool, causal_period: int):
    """K7's masked f32 scores ``q * hd^-0.5`` against ``k`` (BH, S, T)
    and the visibility mask (None without ``causal``)."""
    S, hd = q.shape[1], q.shape[2]
    T = k.shape[1]
    scores = torch.bmm(q.to(F32) * hd ** -0.5, k.to(F32).transpose(1, 2))
    if not causal:
        return scores, None
    dev = q.device
    pos = torch.arange(S, device=dev)
    if causal_period:
        pos = pos % causal_period
    mask = torch.arange(T, device=dev)[None, :] <= pos[:, None]
    return torch.where(mask, scores, NEG_INF), mask


def flash_attention_3d_ref(q, k, v, *, causal: bool = True,
                           causal_period: int = 0, with_lse: bool = False):
    """K7's function on ``q`` (BH, S, hd) and ``k``/``v`` (BH, T, hd):
    materialised scores of ``q * hd^-0.5`` against ``k``, key ``j``
    masked for row ``i`` unless ``j <= i % causal_period`` (``j <= i``
    for period 0; every key without ``causal``), softmax and ``P v``,
    all in f32, output in ``q``'s dtype.  ``with_lse``: also the f32
    row log-sum-exp of the masked scores, (BH, S), as ``(out, lse)``."""
    scores, _ = _scores_3d(q, k, causal, causal_period)
    probs = torch.softmax(scores, dim=-1)
    out = torch.bmm(probs, v.to(F32)).to(q.dtype)
    if not with_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1)


def flash_attention_3d_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                               causal_period: int = 0):
    """The K7 backward's function: ``(dq, dk, dv)`` of K7's output ``o``
    under the cotangent ``do``, from the forward's row log-sum-exp
    ``lse`` (BH, S), by the explicit formula in f32:

        P  = exp(q k^T * hd^-0.5 - lse), invisible keys 0
        D  = rowsum(do * o)
        dv = P^T do;  dP = do v^T;  dS = P * (dP - D)
        dq = dS k * hd^-0.5;  dk = dS^T q * hd^-0.5

    each in its input's dtype.  Under a ``causal_period`` the G folded
    query rows of a slice all reach the same keys, so dk and dv sum over
    them as written."""
    hd = q.shape[2]
    scale = hd ** -0.5
    scores, mask = _scores_3d(q, k, causal, causal_period)
    p = torch.exp(scores - lse.to(F32)[:, :, None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dof = do.to(F32)
    d = (dof * o.to(F32)).sum(dim=-1, keepdim=True)
    dv = torch.bmm(p.transpose(1, 2), dof)
    ds = p * (torch.bmm(dof, v.to(F32).transpose(1, 2)) - d)
    dq = torch.bmm(ds, k.to(F32)) * scale
    dk = torch.bmm(ds.transpose(1, 2), q.to(F32)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: Steps between the states K8's training forward saves (``H``), and the
#: chunk K8-bwd recomputes from each: the reference's ``SCAN_CHUNK``.
SCAN_CHUNK = 64


def _scan_rows_A(A, B: int):
    """``A`` as each batch row uses it: ``(di, N)`` shared by every row,
    or ``(G, di, N)`` with row ``b`` taking ``A[b // (B // G)]``, expanded
    to ``(B, di, N)``."""
    if A.dim() == 2:
        return A
    G = A.shape[0]
    if G == 0 or B % G:
        raise ValueError(f"selective_scan: batch {B} is not a multiple of "
                         f"A's {G} groups")
    return A.repeat_interleave(B // G, dim=0)


def _scan_step(h, x_t, dt_t, b_t, A):
    """One step of the recurrence (the reference's order of products)."""
    da = torch.exp(dt_t.to(F32)[..., None] * A)
    dbx = (dt_t * x_t).to(F32)[..., None] * b_t.to(F32)[:, None, :]
    return da * h + dbx


def selective_scan_fwd_ref(xs, dt, Bc, Cc, A, chunk: int = SCAN_CHUNK):
    """K8's function with the states its backward needs: ``(y, H)``.

    ``xs``, ``dt``: (B, S, di); ``Bc``, ``Cc``: (B, S, N); ``A``: (di, N),
    or (G, di, N) with batch row ``b`` taking ``A[b // (B // G)]``; all
    f32.  From ``h = 0``, each step in the reference's order of products::

        h   = exp(dt_t A) * h + (dt_t x_t) (x) b_t     (B, di, N)
        y_t = sum_n h[:, :, n] c_t[:, n]               (B, di)

    ``y`` is (B, S, di); ``H`` (B, ceil(S / chunk), di, N) holds the state
    before each chunk of ``chunk`` steps (``H[:, 0] = 0``).
    """
    B, S, di = xs.shape
    Ab = _scan_rows_A(A, B)
    h = xs.new_zeros((B, di, A.shape[-1]), dtype=F32)
    ys, hs = [], []
    for t in range(S):
        if t % chunk == 0:
            hs.append(h)
        h = _scan_step(h, xs[:, t], dt[:, t], Bc[:, t], Ab)
        ys.append(torch.einsum("bin,bn->bi", h, Cc[:, t].to(F32)))
    y = torch.stack(ys, dim=1) if ys else xs.new_zeros((B, 0, di))
    H = torch.stack(hs, dim=1) if hs else h.new_zeros((B, 0, di,
                                                       A.shape[-1]))
    return y, H


def selective_scan_ref(xs, dt, Bc, Cc, A):
    """K8's function: the Mamba selective scan from ``h = 0``, the
    reference's step (``repro/models/ssm.py:99-108``) folded over S;
    ``y`` of :func:`selective_scan_fwd_ref`.  (B, S, di) f32."""
    return selective_scan_fwd_ref(xs, dt, Bc, Cc, A)[0]


def selective_scan_bwd_ref(xs, dt, Bc, Cc, A, H, dy,
                           chunk: int = SCAN_CHUNK):
    """K8-bwd's function: ``(dxs, ddt, dBc, dCc, dA)`` of the scan of
    :func:`selective_scan_fwd_ref` (its ``H`` saved at ``chunk``) under
    the cotangent ``dy`` (B, S, di), by an explicit reverse walk.

    Chunks go last to first; each chunk's states are recomputed forward
    from ``H``, then walked back.  With ``da_t = exp(dt_t A)`` and ``dh``
    (B, di, N) from 0, each step does, in order::

        dh     += dy_t[i] c_t
        dC_t[n] = sum_i dy_t[i] h_t[i, n]
        dB_t[n] = sum_i dh[i, n] (dt_t x_t)[i]
        dx_t[i] = dt_t[i] sum_n dh b_t
        ddt_t[i] = x_t[i] sum_n dh b_t + sum_n dh h_{t-1} da_t A
        dA[i, n] += dh h_{t-1} da_t dt_t      (per batch row)
        dh     *= da_t

    ``dA`` is A's shape: the rows' terms summed in row order within each
    of A's groups (over every row for a 2-d ``A``).
    """
    B, S, di = xs.shape
    N = A.shape[-1]
    Ab = _scan_rows_A(A, B)
    dxs, ddt = (xs.new_zeros((B, S, di), dtype=F32) for _ in range(2))
    dBc, dCc = (xs.new_zeros((B, S, N), dtype=F32) for _ in range(2))
    dA_rows, dh = (xs.new_zeros((B, di, N), dtype=F32) for _ in range(2))
    for c in reversed(range(H.shape[1])):
        t0, t1 = c * chunk, min(S, (c + 1) * chunk)
        hs = [H[:, c].to(F32)]
        for t in range(t0, t1):
            hs.append(_scan_step(hs[-1], xs[:, t], dt[:, t], Bc[:, t], Ab))
        for t in reversed(range(t0, t1)):
            h_prev, h_t = hs[t - t0], hs[t - t0 + 1]
            x_t, dt_t = xs[:, t].to(F32), dt[:, t].to(F32)
            dy_t = dy[:, t].to(F32)
            da = torch.exp(dt_t[..., None] * Ab)
            dh = dh + dy_t[..., None] * Cc[:, t].to(F32)[:, None, :]
            dCc[:, t] = torch.einsum("bi,bin->bn", dy_t, h_t)
            dBc[:, t] = torch.einsum("bin,bi->bn", dh, dt_t * x_t)
            sb = torch.einsum("bin,bn->bi", dh, Bc[:, t].to(F32))
            q = dh * h_prev * da
            dxs[:, t] = dt_t * sb
            ddt[:, t] = x_t * sb + (q * Ab).sum(-1)
            dA_rows = dA_rows + q * dt_t[..., None]
            dh = dh * da
    if A.dim() == 2:
        dA = dA_rows.sum(0)
    else:
        dA = dA_rows.reshape((A.shape[0], -1, di, N)).sum(1)
    return dxs, ddt, dBc, dCc, dA


# ---------------------------------------------------------------------------
# The xLSTM scans (K9 mLSTM, K10 sLSTM)
# ---------------------------------------------------------------------------

#: The stabiliser's start, the reference's (not -inf: ``log_f + m - m_new``
#: must stay finite).
M_START = -1e30


def logsigmoid(x):
    """``log(sigmoid(x))`` as the reference computes it, ``-softplus(-x)``
    = ``min(x, 0) - log1p(exp(-|x|))`` (finite for every finite x)."""
    return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-x.abs()))


def mlstm_step(dk: int):
    """The reference's ``_mlstm_step`` (``repro/models/xlstm.py:52-68``):
    ``(carry, xs_t) -> (carry, h_t)`` with carry ``(C, n, m)`` (B, H, dk,
    dv), (B, H, dk), (B, H) and ``xs_t`` = q, k, v (B, H, dk), log_i,
    log_f (B, H), all f32."""
    scale = dk ** -0.5

    def step(carry, xs_t):
        C, n, m = carry
        q, k, v, log_i, log_f = xs_t
        m_new = torch.maximum(log_f + m, log_i)
        i_p = torch.exp(log_i - m_new)
        f_p = torch.exp(log_f + m - m_new)
        C = f_p[..., None, None] * C \
            + i_p[..., None, None] * k[..., :, None] * v[..., None, :]
        n = f_p[..., None] * n + i_p[..., None] * k
        num = torch.einsum("bhkv,bhk->bhv", C, q * scale)
        den = torch.einsum("bhk,bhk->bh", n, q * scale).abs()
        h = num / torch.clamp(den, min=1.0)[..., None]
        return (C, n, m_new), h
    return step


def slstm_step(r_z, r_i, r_f, r_o):
    """The reference's ``_slstm_step`` (``repro/models/xlstm.py:141-160``)
    on the per-head recurrent matrices ``r_*`` (H, dh, dh): ``(carry,
    xs_t) -> (carry, h_t)`` with carry ``(c, n, m, h)`` and ``xs_t`` = zx,
    ix, fx, ox, each (B, H, dh) f32."""
    def rec(w, h):
        return torch.einsum("bhi,hij->bhj", h, w)

    def step(carry, xs_t):
        c, n, m, h = carry
        zx, ix, fx, ox = xs_t
        z_t = torch.tanh(zx + rec(r_z, h))
        i_raw = ix + rec(r_i, h)
        f_raw = fx + rec(r_f, h)
        o_t = torch.sigmoid(ox + rec(r_o, h))
        log_f = logsigmoid(f_raw)
        m_new = torch.maximum(log_f + m, i_raw)
        i_p = torch.exp(i_raw - m_new)
        f_p = torch.exp(log_f + m - m_new)
        c = f_p * c + i_p * z_t
        n = f_p * n + i_p
        h = o_t * c / torch.clamp(n, min=1e-6)
        return (c, n, m_new, h), h
    return step


def _scan_heads(step, carry, xs, chunk: int):
    """``models.ssm.chunked_scan`` of ``step`` over the S axis of the
    (B, S, ...) tensors ``xs``; the outputs back as (B, S, ...).  (The
    model package is imported here, not at the top: it imports the
    kernels' wrappers, which import this module.)"""
    from repro_torch.models.ssm import chunked_scan
    swap = lambda a: a.transpose(0, 1)
    _, hs = chunked_scan(step, carry, tuple(map(swap, xs)), chunk)
    return hs.transpose(0, 1)


def mlstm_scan_ref(q, k, v, log_i, log_f, chunk: int = SCAN_CHUNK):
    """K9's function: the reference's mLSTM step folded over S from
    ``C = 0``, ``n = 0``, ``m = -1e30`` (its ``mlstm_init_state``), as
    ``chunked_scan`` (chunks of ``chunk``) runs it.  q, k, v (B, S, H,
    dk), log_i, log_f (B, S, H), f32 -> h (B, S, H, dk)."""
    B, S, H, dk = q.shape
    C = q.new_zeros((B, H, dk, v.shape[-1]), dtype=F32)
    n = q.new_zeros((B, H, dk), dtype=F32)
    m = q.new_full((B, H), M_START, dtype=F32)
    if S == 0:
        return q.new_zeros((B, 0, H, v.shape[-1]), dtype=F32)
    return _scan_heads(mlstm_step(dk), (C, n, m), (q, k, v, log_i, log_f),
                       chunk)


def slstm_scan_ref(zx, ix, fx, ox, r_z, r_i, r_f, r_o,
                   chunk: int = SCAN_CHUNK):
    """K10's function: the reference's sLSTM step folded over S from
    ``c = n = h = 0``, ``m = -1e30`` (its ``slstm_init_state``), as
    ``chunked_scan`` runs it.  zx, ix, fx, ox (B, S, H, dh), r_* (H, dh,
    dh), f32 -> h (B, S, H, dh)."""
    B, S, H, dh = zx.shape
    zeros = zx.new_zeros((B, H, dh), dtype=F32)
    m = zx.new_full((B, H, dh), M_START, dtype=F32)
    if S == 0:
        return zx.new_zeros((B, 0, H, dh), dtype=F32)
    return _scan_heads(slstm_step(r_z, r_i, r_f, r_o),
                       (zeros, zeros, m, zeros), (zx, ix, fx, ox), chunk)
