"""Declarative client->server wire-protocol codecs + registry.

Counterpart of ``repro/core/codecs/spec.py`` for the synchronous python
driver.  A :class:`CodecSpec` says how a client *encodes* its update
delta, how the server *decodes and aggregates* the cohort, and how many
bytes the encoding puts on the wire; both engines interpret it.

Wire model
----------
Codecs work on the flat-packed update delta: the client's
pseudo-gradient ``w0 - w_k`` in the ``(rows, 128)`` layout of
``kernels/flatpack.py``.  Per selected client ``i`` with delta ``x_i``::

    vals_i, scale_i, ef_i' = encode(cfg, draws, i, x_i, ef_i)
    agg = sum_k m_k * scale_k * vals_k / max(sum_k m_k, 1)   # K5
    agg = post_decode(cfg, draws, agg)          # linear inverse, if any
    agg = post_aggregate(cfg, draws, agg, n)    # server side, if any

``vals`` stays float32 even for quantizing codecs (the values are the
code points; :attr:`CodecSpec.uplink_bytes` reports the wire cost).
The aggregate is one launch of the codec-aggregate kernel
(``kernels/codec.py``) over the stacked ``(K, rows, 128)`` cohort.

Randomness
----------
The reference keys its codec draws by ``round_key(cfg, t)`` in
``jax.random``, which PyTorch cannot reproduce.  The port puts every
draw of a round behind one function, :func:`round_draws`: it draws on
the host from numpy ``default_rng([cfg.seed ^ 0x0DEC, t, stream,
slot])`` and moves the draws to the trainer's device, so the card and
the CPU see the same numbers.  Encoders take these ``draws`` where the
reference takes ``key``; per-client draws are indexed by cohort slot,
as the reference folds the slot into its key.  The tests replace
:func:`round_draws` with the reference's own draws to hold the lossy
codecs to the reference.

``codec="none"`` (``encode is None``) is structurally trivial
(:func:`is_trivial`): every path keeps its exact pre-codec program, with
no packing and no draws.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.flatpack import LANES

#: Bytes of one dense float32 scalar -- the baseline wire width.
DENSE_BYTES = 4.0

F32 = torch.float32


@dataclass(frozen=True)
class CodecSpec:
    """One client->server wire format, declaratively.

    - ``encode(cfg, draws, idx, flat, ef) -> (vals, scale, ef_new)``:
      ``flat`` is the client's ``(rows, 128)`` delta, ``idx`` its cohort
      slot, ``ef`` its error-feedback slab (``None`` unless
      ``error_feedback``).  Returns float32 values of the same shape, a
      scalar dequantization scale and the new error feedback (``None``
      when stateless).  ``None`` encode = the identity codec.
    - ``post_decode(cfg, draws, agg) -> agg``: linear inverse transform
      of the aggregate (e.g. undoing a shared rotation).
    - ``post_aggregate(cfg, draws, agg, count) -> agg``: server-side
      transform of the aggregate (e.g. DP noise); never runs on an
      empty cohort.
    - ``uplink_bytes(cfg, n) -> float``: bytes one client sends for
      ``n`` real parameters; ``None`` = dense float32.
    - ``error_feedback``: the codec keeps a per-client residual slab.
    - ``uses_rng``: encode or a post stage reads :func:`round_draws`.
    """
    name: str
    summary: str
    encode: Optional[Callable[..., Any]] = None
    post_decode: Optional[Callable[..., Any]] = None
    post_aggregate: Optional[Callable[..., Any]] = None
    uplink_bytes: Optional[Callable[[Any, int], float]] = None
    error_feedback: bool = False
    uses_rng: bool = False


class CodecDraws(NamedTuple):
    """One round's codec randomness, on the trainer's device."""
    signs: torch.Tensor   # (LANES,) float32 +-1, shared by the round
    u: torch.Tensor       # (k, rows, LANES) float32 uniforms, per slot
    noise: torch.Tensor   # (rows, LANES) float32 standard normals


def is_trivial(spec: CodecSpec) -> bool:
    """True when the codec is the identity wire format."""
    return spec.encode is None


_REGISTRY: Dict[str, CodecSpec] = {}


def _check_codec(spec: CodecSpec) -> None:
    """Completeness check at registration."""
    def bad(msg):
        raise ValueError(f"CodecSpec {spec.name!r}: {msg}")

    if not spec.name or not spec.name.isidentifier():
        bad(f"name must be a non-empty identifier, got {spec.name!r}")
    if spec.encode is None:
        for field in ("post_decode", "post_aggregate", "uplink_bytes"):
            if getattr(spec, field) is not None:
                bad(f"{field} is meaningless without encode; a trivial "
                    f"codec must be the full identity")
        if spec.error_feedback or spec.uses_rng:
            bad("error_feedback/uses_rng are meaningless without encode")


def register_codec(spec: CodecSpec, *, override: bool = False) -> CodecSpec:
    """Register ``spec`` under ``spec.name``; duplicates need
    ``override=True``."""
    _check_codec(spec)
    if spec.name in _REGISTRY and not override:
        raise ValueError(
            f"codec {spec.name!r} is already registered; pass "
            f"override=True to replace it")
    _REGISTRY[spec.name] = spec
    return spec


def unregister_codec(name: str) -> None:
    """Remove ``name`` from the registry (test cleanup)."""
    _REGISTRY.pop(name, None)


def available_codecs() -> Tuple[str, ...]:
    """Sorted names of every registered codec."""
    return tuple(sorted(_REGISTRY))


def codec_spec(name: str) -> CodecSpec:
    """Look up a registered codec; unknown names raise with the full
    sorted list."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; registered: "
            f"{', '.join(available_codecs())}") from None


# -- driver-facing helpers ---------------------------------------------------

#: ``round_draws`` streams: the shared signs, the per-slot uniforms, the
#: server noise.
STREAM_SIGNS, STREAM_SLOT, STREAM_NOISE = 0, 1, 2


def round_draws(spec: CodecSpec, cfg, t: int, k: int, rows: int,
                device="cpu", idx0: int = 0) -> Optional[CodecDraws]:
    """Every codec draw of round ``t`` for the ``k`` cohort slots
    ``idx0 .. idx0+k-1`` of ``(rows, LANES)`` deltas, or ``None`` for a
    codec without randomness.  Drawn on the host from numpy generators
    keyed by ``(cfg.seed ^ 0x0DEC, t, stream, slot)``, then moved to
    ``device``.  ``u[i]`` is slot ``idx0 + i``: a rank of the client mesh
    passes its first row as ``idx0`` and draws exactly the unsharded
    round's uniforms for its slots; the shared signs and noise are the
    same on every rank.
    """
    if not spec.uses_rng:
        return None
    base = (cfg.seed ^ 0x0DEC) & 0xFFFFFFFF

    def gen(stream: int, slot: int = 0) -> np.random.Generator:
        return np.random.default_rng([base, int(t), stream, slot])

    signs = gen(STREAM_SIGNS).integers(0, 2, LANES).astype(np.float32)
    signs = 2.0 * signs - 1.0
    u = np.stack([gen(STREAM_SLOT, idx0 + i).random((rows, LANES),
                                                    dtype=np.float32)
                  for i in range(k)]) if k else \
        np.zeros((0, rows, LANES), np.float32)
    noise = gen(STREAM_NOISE).standard_normal((rows, LANES),
                                              dtype=np.float32)
    return CodecDraws(*(torch.from_numpy(a).to(device)
                        for a in (signs, u, noise)))


def encode_stacked(spec: CodecSpec, cfg, draws, flats, efs):
    """Client-side encode over a stacked ``(K, rows, 128)`` cohort of
    deltas, slot ``i`` for row ``i``.  ``efs``: the matching stacked
    error feedback (``None`` unless ``spec.error_feedback``).  Returns
    ``(vals (K, rows, 128), scales (K,), ef_new)``, ``ef_new`` ``None``
    for stateless codecs."""
    outs = [spec.encode(cfg, draws, i, flats[i],
                        efs[i] if spec.error_feedback else None)
            for i in range(flats.shape[0])]
    vals = torch.stack([o[0] for o in outs])
    scales = torch.stack([torch.as_tensor(o[1], dtype=F32,
                                          device=flats.device)
                          for o in outs])
    ef_new = (torch.stack([o[2] for o in outs])
              if spec.error_feedback else None)
    return vals, scales, ef_new


def decode_aggregate(spec: CodecSpec, cfg, draws, agg, count):
    """Server-side tail of the decode: the linear inverse transform,
    then the aggregate-level transform, skipped for an empty cohort so
    that the round stays a no-op.  ``count`` may be a tensor."""
    if spec.post_decode is not None:
        agg = spec.post_decode(cfg, draws, agg)
    if spec.post_aggregate is not None:
        count = torch.as_tensor(count, dtype=F32, device=agg.device)
        noisy = spec.post_aggregate(cfg, draws, agg,
                                    torch.clamp(count, min=1.0))
        agg = torch.where(count > 0, noisy, agg)
    return agg


def init_ef(spec: CodecSpec, fspec, num_devices: int, device="cpu"):
    """Zero error feedback for ``fspec`` (a ``kernels.flatpack.FlatSpec``):
    ``None`` for stateless codecs, else a
    :class:`~repro_torch.core.client_state.SparseClientState` of
    ``(rows, 128)`` slabs keyed by client id."""
    if not spec.error_feedback:
        return None
    from repro_torch.core.client_state import SparseClientState
    return SparseClientState(
        num_devices, torch.zeros((fspec.rows, LANES), dtype=F32,
                                 device=device))


def round_bytes(algo_spec, codec: CodecSpec, cfg, n_elems: int,
                n_gather: float, n_up: float) -> Tuple[float, float]:
    """Wire bytes ``(up, down)`` for one round, by the reference's model.

    ``n_elems`` real parameters, ``n_gather`` phase-A gradient devices
    that responded (the thinned gather under availability scenarios),
    ``n_up`` solve devices whose update arrived.  Downlink ships ``w0``
    to each separately selected phase-A device and ``w0`` plus (for
    corrected algorithms) one model-width correction to each solve
    device; uplink ships the phase-A gradients dense, each update at the
    codec's width (pipelined FedDANE adds its fresh gradient, dense).
    """
    dense = DENSE_BYTES * n_elems
    enc = (codec.uplink_bytes(cfg, n_elems)
           if codec.uplink_bytes is not None else dense)
    gather_down = n_gather if algo_spec.num_selections == 2 else 0.0
    corr_down = 1.0 if algo_spec.correction is not None else 0.0
    grad_up = 1.0 if algo_spec.updates_g_prev else 0.0
    down = dense * gather_down + dense * (1.0 + corr_down) * n_up
    up = dense * n_gather + (enc + dense * grad_up) * n_up
    return up, down


def topk_keep(cfg, n: int) -> int:
    """Coordinates the top-k codec keeps out of ``n`` (at least one)."""
    return max(1, int(math.ceil(cfg.topk_frac * n)))
