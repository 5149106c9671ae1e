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
# The xLSTM scans (K9 mLSTM, K10 sLSTM) and their backward (K9-bwd, K10-bwd)
# ---------------------------------------------------------------------------

#: The stabiliser's start, the reference's (not -inf: ``log_f + m - m_new``
#: must stay finite).
M_START = -1e30


def logsigmoid(x):
    """``log(sigmoid(x))``, the reference's ``-softplus(-x)``, as ``min(x,
    0) - log1p(exp(-|x|))``: finite for every finite x, and its gradient
    ``sigmoid(-x)`` is the reference's, 0.5 at x = 0 (``torch.minimum``
    splits a tie, and |x|'s gradient there is 0).  (``F.logsigmoid`` has
    no batching rule on CUDA tensors under ``vmap(grad)``.)"""
    return torch.minimum(x, x.new_zeros(())) - torch.log1p(
        torch.exp(-x.abs()))


def tie_share(a, b):
    """The share of ``max(a, b)``'s gradient that goes to ``a``, as the
    reference's ``jnp.maximum`` (and ``torch.maximum``) splits it: 1 where
    a > b, 0.5 where a == b, 0 where a < b."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def _mlstm_state(C, n, m, k, v, log_i, log_f):
    """The mLSTM state update of one step: ``(C, n, m_new, i, f)``."""
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + m - m_new)
    C = f_p[..., None, None] * C \
        + i_p[..., None, None] * k[..., :, None] * v[..., None, :]
    n = f_p[..., None] * n + i_p[..., None] * k
    return C, n, m_new, i_p, f_p


def mlstm_step(dk: int):
    """The reference's ``_mlstm_step`` (``repro/models/xlstm.py:52-68``):
    ``(carry, xs_t) -> (carry, h_t)`` with carry ``(C, n, m)`` (B, H, dk,
    dv), (B, H, dk), (B, H) and ``xs_t`` = q, k, v (B, H, dk), log_i,
    log_f (B, H), all f32."""
    scale = dk ** -0.5

    def step(carry, xs_t):
        q, k, v, log_i, log_f = xs_t
        C, n, m_new, _, _ = _mlstm_state(*carry, k, v, log_i, log_f)
        num = torch.einsum("bhkv,bhk->bhv", C, q * scale)
        den = torch.einsum("bhk,bhk->bh", n, q * scale).abs()
        h = num / torch.maximum(den, den.new_ones(()))[..., None]
        return (C, n, m_new), h
    return step


def _slstm_rows(r, B: int):
    """A recurrent matrix as each batch row uses it: ``(H, dh, dh)``
    shared by every row, or ``(G, H, dh, dh)`` with row ``b`` taking
    ``r[b // (B // G)]``, expanded to ``(B, H, dh, dh)``."""
    if r.dim() == 3:
        return r
    G = r.shape[0]
    if G == 0 or B % G:
        raise ValueError(f"slstm_scan: batch {B} is not a multiple of the "
                         f"recurrent matrices' {G} groups")
    return r.repeat_interleave(B // G, dim=0)


def _rec(r, h):
    """``h @ r`` a head: ``r`` (H, dh, dh) shared, or (B, H, dh, dh) a
    row."""
    if r.dim() == 3:
        return torch.einsum("bhi,hij->bhj", h, r)
    return torch.einsum("bhi,bhij->bhj", h, r)


def _slstm_cell(c, n, m, pz, pi, pf, po):
    """The sLSTM cell of one step on the gates' pre-activations:
    ``(c, n, m_new, h)``."""
    z_t = torch.tanh(pz)
    o_t = torch.sigmoid(po)
    log_f = logsigmoid(pf)
    m_new = torch.maximum(log_f + m, pi)
    i_p = torch.exp(pi - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p * c + i_p * z_t
    n = f_p * n + i_p
    h = o_t * c / torch.maximum(n, n.new_full((), 1e-6))
    return c, n, m_new, h


def slstm_step(r_z, r_i, r_f, r_o):
    """The reference's ``_slstm_step`` (``repro/models/xlstm.py:141-160``)
    on the per-head recurrent matrices ``r_*`` (H, dh, dh), or (B, H, dh,
    dh) a batch row: ``(carry, xs_t) -> (carry, h_t)`` with carry ``(c,
    n, m, h)`` and ``xs_t`` = zx, ix, fx, ox, each (B, H, dh) f32."""
    rs = (r_z, r_i, r_f, r_o)

    def step(carry, xs_t):
        c, n, m, h = carry
        pre = [x + _rec(r, h) for x, r in zip(xs_t, rs)]
        c, n, m, h = _slstm_cell(c, n, m, *pre)
        return (c, n, m, h), h
    return step


def _mlstm_start(q, v):
    B, _, H, dk = q.shape
    return (q.new_zeros((B, H, dk, v.shape[-1]), dtype=F32),
            q.new_zeros((B, H, dk), dtype=F32),
            q.new_full((B, H), M_START, dtype=F32))


def mlstm_scan_ref(q, k, v, log_i, log_f, chunk: int = SCAN_CHUNK):
    """K9's function: the reference's mLSTM step folded over S from
    ``C = 0``, ``n = 0``, ``m = -1e30`` (its ``mlstm_init_state``), as
    ``chunked_scan`` runs it (chunks of ``chunk`` change no value).  q, k,
    v (B, S, H, dk), log_i, log_f (B, S, H), f32 -> h (B, S, H, dk); the
    ``h`` of :func:`mlstm_scan_fwd_ref`."""
    return mlstm_scan_fwd_ref(q, k, v, log_i, log_f, chunk)[0]


def mlstm_scan_fwd_ref(q, k, v, log_i, log_f, chunk: int = SCAN_CHUNK):
    """K9's training launch: ``(h, C, n, m)``, ``h`` of the scan
    (:func:`mlstm_scan_ref`) and the state before each chunk of
    ``chunk`` steps, ``C`` (B, ceil(S / chunk), H, dk, dv), ``n`` (B,
    ceil(S / chunk), H, dk), ``m`` (B, ceil(S / chunk), H)."""
    B, S, H, dk = q.shape
    carry, step = _mlstm_start(q, v), mlstm_step(dk)
    hs, saved = [], []
    for t in range(S):
        if t % chunk == 0:
            saved.append(carry)
        carry, h = step(carry, (q[:, t], k[:, t], v[:, t], log_i[:, t],
                                log_f[:, t]))
        hs.append(h)
    if S == 0:
        return (q.new_zeros((B, 0, H, v.shape[-1]), dtype=F32),
                *(a.new_zeros((B, 0) + a.shape[1:]) for a in carry))
    return (torch.stack(hs, 1), *(torch.stack(s, 1) for s in zip(*saved)))


def mlstm_scan_bwd_ref(q, k, v, log_i, log_f, h, C, n, m, dh,
                       chunk: int = SCAN_CHUNK):
    """K9-bwd's function: ``(dq, dk, dv, dlog_i, dlog_f)`` of the scan of
    :func:`mlstm_scan_fwd_ref` (its ``h`` and the states ``C``, ``n``,
    ``m`` saved at ``chunk``) under the cotangent ``dh`` (B, S, H, dv),
    by an explicit reverse walk.

    Chunks go last to first; each chunk's states are recomputed forward
    from the saved ones, then walked back.  With ``s = dk^-1/2``, ``den
    = n_t . q s``, ``D = max(|den|, 1)`` and dC, dn, dm from 0, each step
    does, in order::

        dden = -(dh . h_t) / D * [|den| vs 1] * sign(den);  dnum = dh / D
        dC  += (q s) (x) dnum;  dn += q s dden
        dq   = s (C_t dnum + n_t dden)
        u    = dC v + dn;  dk = i u;  di = k . u;  dv = i dC^T k
        df   = sum(dC * C_{t-1}) + dn . n_{t-1};  dC *= f;  dn *= f
        dm'  = dm - di i - df f                 (m' = max(log_f + m, log_i))
        dlog_i = di i + dm' [log_i vs log_f + m]
        dlog_f = df f + dm' [log_f + m vs log_i];  dm = dlog_f

    where ``[a vs b]`` is :func:`tie_share` (1, 0.5 at a tie, 0): the
    stabiliser ``m`` is differentiated as autodiff does (the clamps make
    ``h`` depend on it).
    """
    B, S, H, dk = q.shape
    scale = dk ** -0.5
    dq, dk_, dv = (torch.zeros_like(a, dtype=F32) for a in (q, k, v))
    dli, dlf = (torch.zeros_like(a, dtype=F32) for a in (log_i, log_f))
    dC = torch.zeros_like(C[:, 0]) if C.shape[1] else None
    dn = torch.zeros_like(n[:, 0]) if C.shape[1] else None
    dm = torch.zeros_like(m[:, 0]) if C.shape[1] else None
    for c in reversed(range(C.shape[1])):
        t0, t1 = c * chunk, min(S, (c + 1) * chunk)
        st = [(C[:, c], n[:, c], m[:, c], None, None)]
        for t in range(t0, t1):
            st.append(_mlstm_state(*st[-1][:3], k[:, t], v[:, t],
                                   log_i[:, t], log_f[:, t]))
        for t in reversed(range(t0, t1)):
            C_prev, n_prev, m_prev = st[t - t0][:3]
            C_t, n_t, _, i_p, f_p = st[t - t0 + 1]
            qs = q[:, t] * scale
            den = torch.einsum("bhk,bhk->bh", n_t, qs)
            D = torch.maximum(den.abs(), den.new_ones(()))
            dden = (-(dh[:, t] * h[:, t]).sum(-1) / D
                    * tie_share(den.abs(), 1.0) * torch.sign(den))
            dnum = dh[:, t] / D[..., None]
            dC = dC + qs[..., :, None] * dnum[..., None, :]
            dn = dn + qs * dden[..., None]
            dq[:, t] = scale * (torch.einsum("bhkv,bhv->bhk", C_t, dnum)
                                + n_t * dden[..., None])
            u = torch.einsum("bhkv,bhv->bhk", dC, v[:, t]) + dn
            dk_[:, t] = i_p[..., None] * u
            di = (k[:, t] * u).sum(-1)
            dv[:, t] = i_p[..., None] * torch.einsum("bhkv,bhk->bhv", dC,
                                                     k[:, t])
            df = (dC * C_prev).sum((-2, -1)) + (dn * n_prev).sum(-1)
            dC = f_p[..., None, None] * dC
            dn = f_p[..., None] * dn
            share = tie_share(log_f[:, t] + m_prev, log_i[:, t])
            dm_new = dm - di * i_p - df * f_p
            dli[:, t] = di * i_p + dm_new * (1.0 - share)
            dlf[:, t] = dm = df * f_p + dm_new * share
    return dq, dk_, dv, dli, dlf


def slstm_scan_ref(zx, ix, fx, ox, r_z, r_i, r_f, r_o,
                   chunk: int = SCAN_CHUNK):
    """K10's function: the reference's sLSTM step folded over S from
    ``c = n = h = 0``, ``m = -1e30`` (its ``slstm_init_state``), as
    ``chunked_scan`` runs it (``chunk``, the reference's, changes no
    value).  zx, ix, fx, ox (B, S, H, dh), r_* (H, dh, dh), or (G, H, dh,
    dh) with batch row ``b`` taking group ``b // (B // G)``, f32 -> h (B,
    S, H, dh); the ``h`` of :func:`slstm_scan_fwd_ref`."""
    return slstm_scan_fwd_ref(zx, ix, fx, ox, r_z, r_i, r_f, r_o)[0]


#: The states K10's training launch keeps, each (B, S, H, dh): the cell
#: state after each step (c, n, m) and the four gates' pre-activations
#: (``zx + h r_z``, ``ix + h r_i``, ``fx + h r_f``, ``ox + h r_o``).
SLSTM_STATES = ("c", "n", "m", "pz", "pi", "pf", "po")


def slstm_scan_fwd_ref(zx, ix, fx, ox, r_z, r_i, r_f, r_o):
    """K10's training launch: ``(h, c, n, m, pz, pi, pf, po)``, ``h`` of
    the scan (:func:`slstm_scan_ref`) and every step's
    :data:`SLSTM_STATES`, each (B, S, H, dh)."""
    B, S, H, dh = zx.shape
    rs = [_slstm_rows(r, B) for r in (r_z, r_i, r_f, r_o)]
    c = n = h = zx.new_zeros((B, H, dh), dtype=F32)
    m = zx.new_full((B, H, dh), M_START, dtype=F32)
    out = [[] for _ in range(8)]
    for t in range(S):
        pre = [x[:, t] + _rec(r, h) for x, r in zip((zx, ix, fx, ox), rs)]
        c, n, m, h = _slstm_cell(c, n, m, *pre)
        for seq, a in zip(out, [h, c, n, m] + pre):
            seq.append(a)
    if S == 0:
        return tuple(zx.new_zeros((B, 0, H, dh), dtype=F32)
                     for _ in range(8))
    return tuple(torch.stack(seq, 1) for seq in out)


def slstm_scan_bwd_ref(r_z, r_i, r_f, r_o, h, c, n, m, pz, pi, pf, po, dh):
    """K10-bwd's function: ``(dzx, dix, dfx, dox, dr_z, dr_i, dr_f,
    dr_o)`` of the scan of :func:`slstm_scan_fwd_ref` (its ``h`` and
    states) under the cotangent ``dh`` (B, S, H, dh), by an explicit
    reverse walk over t = S-1 .. 0 from dc = dn = dm = 0 and the
    recurrent cotangent g_h = 0.  With ``z = tanh(pz)``, ``o =
    sigmoid(po)``, ``N = max(n_t, 1e-6)`` and ``i``, ``f`` the step's
    gates, each step does, in order::

        g   = dh_t + g_h;   do = g c_t / N
        dc += g o / N;      dn += -g h_t / N [n_t vs 1e-6]
        df  = dc c_{t-1} + dn n_{t-1};  di = dc z + dn;  dz = dc i
        dc *= f;  dn *= f
        dm' = dm - di i - df f
        dpi = di i + dm' [pi vs log_f + m];  dlf = df f + dm' [log_f + m vs pi]
        dm  = dlf;  dpf = dlf sigmoid(-pf)
        dpz = dz (1 - z^2);  dpo = do o (1 - o)
        g_h = sum_g r_g d_g          (d_g: dpz, dpi, dpf, dpo)

    The inputs enter the pre-activations additively, so ``d(zx, ix, fx,
    ox)`` are ``d_g``; ``dr_g = sum_(b, t) h_{t-1} (x) d_g``, a product
    over the saved ``h`` after the walk, per group for grouped r."""
    B, S, H, dh_ = h.shape
    rs = (r_z, r_i, r_f, r_o)
    rows = [_slstm_rows(r, B) for r in rs]
    d = [torch.zeros_like(h) for _ in range(4)]
    zero = h.new_zeros((B, H, dh_))
    m0 = torch.full_like(zero, M_START)
    dc = dn = dm = g_h = zero
    for t in reversed(range(S)):
        c_prev, n_prev, m_prev = ((c[:, t - 1], n[:, t - 1], m[:, t - 1])
                                  if t else (zero, zero, m0))
        z = torch.tanh(pz[:, t])
        o = torch.sigmoid(po[:, t])
        log_f = logsigmoid(pf[:, t])
        i_p = torch.exp(pi[:, t] - m[:, t])
        f_p = torch.exp(log_f + m_prev - m[:, t])
        N = torch.maximum(n[:, t], n.new_full((), 1e-6))
        g = dh[:, t] + g_h
        do = g * c[:, t] / N
        dc = dc + g * o / N
        dn = dn - g * h[:, t] / N * tie_share(n[:, t], 1e-6)
        df = dc * c_prev + dn * n_prev
        di = dc * z + dn
        dz = dc * i_p
        dc, dn = dc * f_p, dn * f_p
        share = tie_share(log_f + m_prev, pi[:, t])
        dm_new = dm - di * i_p - df * f_p
        d[1][:, t] = di * i_p + dm_new * (1.0 - share)
        dm = df * f_p + dm_new * share
        d[2][:, t] = dm * torch.sigmoid(-pf[:, t])
        d[0][:, t] = dz * (1.0 - z * z)
        d[3][:, t] = do * o * (1.0 - o)
        g_h = sum(torch.einsum("bhj,hij->bhi", d_g[:, t], r)
                  if r.dim() == 3 else
                  torch.einsum("bhj,bhij->bhi", d_g[:, t], r)
                  for d_g, r in zip(d, rows))
    h_prev = torch.cat([zero[:, None], h[:, :-1]], 1) if S else h
    return tuple(d) + tuple(slstm_dr(r, h_prev, d_g) for r, d_g in zip(rs, d))


def slstm_dr(r, h_prev, d_g):
    """``dr = sum_(b, t) h_{t-1} (x) d_g`` a head, over every row for an
    (H, dh, dh) ``r``, within each group for a grouped one: a plain
    product over B*S (the reference's autodiff forms it outside any
    kernel too)."""
    if r.dim() == 3:
        return torch.einsum("bshi,bshj->hij", h_prev, d_g)
    G = r.shape[0]
    shape = (G, -1) + tuple(h_prev.shape[1:])
    return torch.einsum("gbshi,gbshj->ghij", h_prev.reshape(shape),
                        d_g.reshape(shape))
