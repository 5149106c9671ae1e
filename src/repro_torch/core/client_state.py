"""Sparse per-client persistent state keyed by client id.

Counterpart of ``repro/core/client_state.py``.  SCAFFOLD's control
variates persist per client across rounds; :class:`SparseClientState`
keeps them as a dict keyed by client id over a shared zero template, so
memory is O(clients ever selected), not O(N).  Reads of never-written
clients return the template (the dense layout's zeros; the template is
never written in place).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch

from repro_torch.core import pytree as pt

_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64,
           torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Exact equality that no denormal flush can change.

    Float tensors compare as bit patterns (with +0 == -0): a float
    compare may run with denormals treated as zero, which would call a
    subnormal row equal to the zero template and drop it.
    """
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ity = _INT_OF.get(a.dtype)
    if ity is None:
        return bool(torch.equal(a, b))
    ia, ib = a.contiguous().view(ity), b.contiguous().view(ity)
    sign = torch.iinfo(ity).min            # only the sign bit set
    zero_a = (ia & ~sign) == 0
    zero_b = (ib & ~sign) == 0
    return bool(((ia == ib) | (zero_a & zero_b)).all())


class SparseClientState:
    """Dict-of-trees with a zero default, dense-list compatible
    (``st[k]``, ``st[k] = v``, iteration) plus the cohort
    gather/scatter of the batched round."""

    def __init__(self, num_clients: int, template: Any):
        """``template``: the zero tree a never-written client reads
        (shared, never mutated); ``num_clients`` bounds valid ids."""
        self.num_clients = int(num_clients)
        self.template = template
        self._store: Dict[int, Any] = {}
        #: high-water mark of stored clients: O(cohorts), never O(N)
        self.peak_clients = 0

    def _check(self, k: int) -> int:
        k = int(k)
        if not 0 <= k < self.num_clients:
            raise IndexError(
                f"client id {k} out of range [0, {self.num_clients})")
        return k

    def __getitem__(self, k: int) -> Any:
        return self._store.get(self._check(k), self.template)

    def __setitem__(self, k: int, value: Any) -> None:
        self._store[self._check(k)] = value
        self.peak_clients = max(self.peak_clients, len(self._store))

    def evict(self, k: int) -> None:
        """Drop client k's row: it reads the template again, as a dense
        row reset to zeros would."""
        self._store.pop(self._check(k), None)

    def __len__(self) -> int:
        return len(self._store)

    def __iter__(self):
        """Dense iteration order: row k for every client id (O(N))."""
        for k in range(self.num_clients):
            yield self[k]

    def gather(self, ids: Iterable[int]) -> Any:
        """The cohort's rows stacked along a new leading axis."""
        return pt.stack([self[int(k)] for k in ids])

    def scatter(self, ids: Iterable[int], stacked: Any) -> None:
        """Write a K-stacked cohort result back row by row; duplicate ids
        apply in order (last writer wins)."""
        for i, k in enumerate(ids):
            self[int(k)] = pt.index(stacked, i)

    def to_dense(self) -> List[Any]:
        """The equivalent dense length-N list (small N only)."""
        return [self[k] for k in range(self.num_clients)]

    @classmethod
    def from_dense(cls, rows: List[Any],
                   template: Optional[Any] = None) -> "SparseClientState":
        """Build from a dense list; rows exactly equal to ``template``
        (default: zeros like row 0) stay unstored."""
        if template is None:
            template = pt.zeros_like(rows[0])
        st = cls(len(rows), template)
        tl = pt.leaves(template)
        for k, row in enumerate(rows):
            if not all(_equal(a, b) for a, b in zip(pt.leaves(row), tl)):
                st[k] = row
        return st
