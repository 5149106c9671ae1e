"""Flat-parameter packing: one ``(rows, LANES)`` f32 buffer per tree.

Counterpart of ``repro/kernels/flatpack.py``, with the same layout (the
flat update K1 and the codec layer both rely on it)::

    row 0 .. rows-1      device 0:  leaf0 | leaf1 | ... | zero pad
    row rows .. 2*rows-1 device 1:  leaf0 | leaf1 | ... | zero pad
    ...                                   (each row = 128 lanes)

Leaves follow the reference's order (sorted dict keys); each device's
segment is padded to a multiple of ``ROW_ALIGN`` rows, so a row never
straddles devices and the masked update kernel can find a row's device
as ``row // rows``.  Packing is pure layout: every element round-trips
through f32 exactly, so the flat path equals the per-leaf path bitwise.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core import pytree as pt
from repro_torch.kernels.dane_update import LANES

#: Per-device segments are padded to a multiple of this many rows.
ROW_ALIGN = 8


class FlatSpec(NamedTuple):
    """Static packing layout for one (unstacked) parameter tree."""

    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[Any, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int                             # sum(sizes)
    rows: int                              # ceil(total/LANES) -> ROW_ALIGN

    @property
    def padded(self) -> int:
        """Elements per device segment after lane padding."""
        return self.rows * LANES


def flat_spec(tree) -> FlatSpec:
    """The layout table of an (unstacked) tree (shapes and dtypes only)."""
    leaves, treedef = pt.flatten(tree)
    shapes = tuple(tuple(x.shape) for x in leaves)
    dtypes = tuple(x.dtype for x in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets, off = [], 0
    for n in sizes:
        offsets.append(off)
        off += n
    rows = -(-off // LANES)
    rows = -(-max(rows, 1) // ROW_ALIGN) * ROW_ALIGN
    return FlatSpec(treedef, shapes, dtypes, sizes, tuple(offsets),
                    off, rows)


def _pad_cols(flat2d, spec: FlatSpec):
    pad = spec.padded - spec.total
    if pad:
        flat2d = torch.cat(
            [flat2d, flat2d.new_zeros((flat2d.shape[0], pad))], dim=1)
    return flat2d


def pack(spec: FlatSpec, tree) -> torch.Tensor:
    """Unstacked tree -> ``(rows, LANES)`` f32 buffer."""
    flat = torch.cat([x.reshape(1, -1).to(torch.float32)
                      for x in pt.leaves(tree)], dim=1)
    return _pad_cols(flat, spec).reshape(spec.rows, LANES)


def unpack(spec: FlatSpec, buf) -> Any:
    """``(rows, LANES)`` buffer -> unstacked tree (leaf dtypes kept)."""
    flat = buf.reshape(spec.padded)
    leaves = [flat[off:off + n].reshape(shape).to(dt)
              for off, n, shape, dt in zip(spec.offsets, spec.sizes,
                                           spec.shapes, spec.dtypes)]
    return pt.unflatten(spec.treedef, leaves)


def pack_stacked(spec: FlatSpec, tree, k: int) -> torch.Tensor:
    """K-stacked tree (leaves ``(K, ...)``) -> ``(K*rows, LANES)``."""
    flat = torch.cat([x.reshape(k, -1).to(torch.float32)
                      for x in pt.leaves(tree)], dim=1)
    return _pad_cols(flat, spec).reshape(k * spec.rows, LANES)


def unpack_stacked(spec: FlatSpec, buf, k: int) -> Any:
    """``(K*rows, LANES)`` buffer -> K-stacked tree."""
    flat = buf.reshape(k, spec.padded)
    leaves = [flat[:, off:off + n].reshape((k,) + shape).to(dt)
              for off, n, shape, dt in zip(spec.offsets, spec.sizes,
                                           spec.shapes, spec.dtypes)]
    return pt.unflatten(spec.treedef, leaves)


def stacked_slots(spec: FlatSpec, buf, k: int):
    """Each leaf's ``(K, size)`` view of a ``(K*rows, LANES)`` buffer, in
    leaf order."""
    flat = buf.view(k, spec.padded)
    return [flat[:, off:off + n] for off, n in zip(spec.offsets, spec.sizes)]


def pack_stacked_into(slots, tree) -> None:
    """Write a K-stacked tree's leaves into their :func:`stacked_slots`
    of a buffer, one ``copy_`` (cast to f32) per leaf; the pad is left as
    it is."""
    for s, x in zip(slots, pt.leaves(tree)):
        s.copy_(x.reshape(s.shape))


def pack_broadcast(spec: FlatSpec, tree, k: int) -> torch.Tensor:
    """Unstacked tree broadcast to K devices: ``(K*rows, LANES)``."""
    one = pack(spec, tree)
    return one.unsqueeze(0).expand((k,) + one.shape) \
        .reshape(k * spec.rows, LANES)
