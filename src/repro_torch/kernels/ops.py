"""Public wrappers around the update kernels (K1, K4) over parameter
trees, and the GQA wrapper of the attention kernel (K7).

Counterpart of the ``dane_update*`` and ``flash_attention`` wrappers of
``repro/kernels/ops.py``.  Each launches the CUDA kernel for tensors on
the card and the plain version for tensors on the CPU (the choice is
made in ``kernels/dane_update.py`` and ``kernels/flash_attention.py``);
launches are counted in ``kernels.build.launch_counts``.  On the card a
tree's update is one launch over all its leaves, unpadded; on the CPU
each leaf is padded to ``(rows, LANES)`` as the reference pads it.
"""
from __future__ import annotations

import torch

from repro_torch.core import pytree as pt
from repro_torch.kernels import flatpack
from repro_torch.kernels.dane_update import (LANES, dane_update_2d,
                                             dane_update_flat,
                                             dane_update_leaves)
from repro_torch.kernels.flash_attention import flash_attention_3d


def _pad_2d(a):
    """Flatten to (rows, LANES) with zero pad; returns (view, orig_size)."""
    flat = a.reshape(-1)
    n = flat.shape[0]
    rows = -(-n // LANES)
    pad = rows * LANES - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(rows, LANES), n


def _leaves_on_card(ws, treedef, grad_tree, corr_tree, anchor_tree, eta,
                    mu, mask=None):
    """One :func:`dane_update_leaves` launch over the leaves ``ws`` of
    the ``w`` tree (``treedef``) and those of the other trees."""
    return pt.unflatten(treedef, dane_update_leaves(
        ws, pt.leaves(grad_tree), pt.leaves(corr_tree),
        pt.leaves(anchor_tree), eta, mu, mask))


def dane_update_array(w, grad, g_corr, anchor, eta, mu):
    """Fused update (K4) for one array of any shape."""
    if w.is_cuda:
        return dane_update_leaves([w], [grad], [g_corr], [anchor], eta,
                                  mu)[0]
    w2, n = _pad_2d(w)
    g2, _ = _pad_2d(grad)
    c2, _ = _pad_2d(g_corr)
    a2, _ = _pad_2d(anchor)
    out = dane_update_2d(w2, g2, c2, a2, eta, mu)
    return out.reshape(-1)[:n].reshape(w.shape)


def dane_update(w_tree, grad_tree, corr_tree, anchor_tree, eta, mu):
    """The fused FedDANE step leaf-wise over parameter trees (on the
    card one K4 launch for every leaf)."""
    ws, treedef = pt.flatten(w_tree)
    if ws[0].is_cuda:
        return _leaves_on_card(ws, treedef, grad_tree, corr_tree,
                               anchor_tree, eta, mu)
    return pt.tmap(
        lambda w, g, c, a: dane_update_array(w, g, c, a, eta, mu),
        w_tree, grad_tree, corr_tree, anchor_tree)


def dane_update_masked(w_tree, grad_tree, corr_tree, anchor_tree, eta, mu,
                       valid):
    """The step over *device-stacked* trees with a ``(K,)`` step mask
    (devices with ``valid`` not > 0 keep ``w``) -- the ``per_leaf``
    solver mode.  On the card ONE launch for every leaf and device, the
    select done in the kernel; on the CPU the update per leaf, then the
    select."""
    ws, treedef = pt.flatten(w_tree)
    if ws[0].is_cuda:
        return _leaves_on_card(ws, treedef, grad_tree, corr_tree,
                               anchor_tree, eta, mu, valid)
    new = dane_update(w_tree, grad_tree, corr_tree, anchor_tree, eta, mu)

    def select(n, o):
        keep = valid.reshape(valid.shape + (1,) * (n.ndim - 1)) > 0
        return torch.where(keep, n, o)

    return pt.tmap(select, new, w_tree)


def dane_update_flat_masked(wf, gf, cf, af, eta, mu, valid,
                            rows_per_dev: int):
    """Masked step on flat-packed ``(K*rows, LANES)`` buffers: ONE K1
    launch for all leaves and devices, the mask resolved in the kernel.
    Per-element arithmetic equals the per-leaf path's bitwise."""
    return dane_update_flat(wf, gf, cf, af, eta, mu, valid, rows_per_dev)


class FlatUpdate:
    """The ``flat`` solver mode's update over one solve of K devices.

    ``w`` stays a ``(K*rows, LANES)`` f32 pack from step to step: each
    :meth:`step` packs only the gradient (one ``copy_`` per leaf into a
    buffer whose zero pad is written once), launches K1 into the other
    of two pack buffers and hands out the new ``w`` tree as views of it,
    made once per buffer (leaves stored in another dtype are cast
    copies, written back into the pack so that it holds what the tree
    holds).  A
    step's tree stays valid until the step after next writes its buffer
    again.  The first step starts from the anchor.  Bitwise equal to
    packing ``w`` and ``g`` anew every step.
    """

    def __init__(self, spec, corr_tree, w0_tree, k: int):
        self.spec, self.k = spec, k
        self.corr = flatpack.pack_stacked(spec, corr_tree, k)
        self.anchor = flatpack.pack_broadcast(spec, w0_tree, k)
        self.w = self.anchor
        self.g = torch.zeros_like(self.anchor)
        self._g_slots = flatpack.stacked_slots(spec, self.g, k)
        self._cast = [i for i, dt in enumerate(spec.dtypes)
                        if dt != torch.float32]
        # the two buffers, each with its w tree (views where f32) and
        # leaf slots
        self._bufs = []
        for _ in range(2):
            b = torch.empty_like(self.anchor)
            self._bufs.append((b, flatpack.unpack_stacked(spec, b, k),
                               flatpack.stacked_slots(spec, b, k)))

    def step(self, grad_tree, eta, mu, valid):
        """One masked step from the gradient tree; returns the new ``w``
        tree (K-stacked leaves)."""
        flatpack.pack_stacked_into(self._g_slots, grad_tree)
        out, tree, slots = self._bufs[0]
        self._bufs.reverse()
        self.w = dane_update_flat(self.w, self.g, self.corr, self.anchor,
                                  eta, mu, valid, self.spec.rows, out=out)
        if not self._cast:
            return tree
        tree = flatpack.unpack_stacked(self.spec, out, self.k)
        leaves = pt.leaves(tree)
        for i in self._cast:
            slots[i].copy_(leaves[i].reshape(slots[i].shape))
        return tree


def dane_update_tree_masked(w_tree, grad_tree, corr_tree, anchor_tree,
                            eta, mu, valid):
    """Pack -> ONE K1 launch -> unpack, with tree in and out; a drop-in
    for :func:`dane_update_masked`."""
    spec = flatpack.flat_spec(pt.index(w_tree, 0))
    k = pt.leaves(w_tree)[0].shape[0]
    wf = flatpack.pack_stacked(spec, w_tree, k)
    gf = flatpack.pack_stacked(spec, grad_tree, k)
    cf = flatpack.pack_stacked(spec, corr_tree, k)
    af = flatpack.pack_stacked(spec, anchor_tree, k)
    out = dane_update_flat_masked(wf, gf, cf, af, eta, mu, valid,
                                  spec.rows)
    return flatpack.unpack_stacked(spec, out, k)


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, S, H, hd); k, v: (B, T, Kv, hd) -> (B, S, H, hd).

    The reference's GQA wrapper, in its own head order: query head
    ``h = n * group + g`` reads KV head ``n`` (``repeat`` order).  Its
    ``group`` heads of one KV head are folded into ``(B*Kv, group*S,
    hd)`` query rows, whose sequence position the kernel recovers as
    ``row % S`` (``causal_period``).  The model path does not use it: the
    model's heads are in tile order (``models/attention.flash_gqa``).
    """
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    group = H // Kv

    def to3(a):
        return a.permute(0, 2, 1, 3).reshape(B * a.shape[2], -1, hd)

    q3 = q.reshape(B, S, Kv, group, hd).permute(0, 2, 3, 1, 4) \
        .reshape(B * Kv, group * S, hd)
    o = flash_attention_3d(q3, to3(k), to3(v), causal=causal,
                           causal_period=S)
    return o.reshape(B, Kv, group, S, hd).permute(0, 3, 1, 2, 4) \
        .reshape(B, S, H, hd)
