"""The vmap rules' fold of the mapped dim into a kernel's leading dim.

A kernel's autograd Function under ``torch.func.vmap`` (the trainer's
``vmap(grad)`` over K clients) launches once for the whole batch: each
input's mapped dim goes to the front and merges with the leading dim
(K7's BH, K8's B), and each output is split back into ``(batch, ...)``.
"""
from __future__ import annotations


def fold(info, in_dims, *tensors):
    """The mapped dim of each tensor moved to the front (broadcast where
    unmapped) and merged into the leading dim: ``(batch * lead, ...)``
    tensors."""
    out = []
    for t, dim in zip(tensors, in_dims):
        t = (t.movedim(dim, 0) if dim is not None
             else t.expand((info.batch_size,) + t.shape))
        out.append(t.reshape((-1,) + t.shape[2:]))
    return out


def fold_contiguous(info, in_dims, *tensors):
    """:func:`fold`, each tensor made contiguous (the kernels' layout;
    nested vmaps hand over expanded views)."""
    return [t.contiguous() for t in fold(info, in_dims, *tensors)]


def unfold(info, t):
    """A folded output back to ``(batch, lead, ...)``; None stays None."""
    return None if t is None else t.reshape(
        (info.batch_size, -1) + t.shape[1:])
