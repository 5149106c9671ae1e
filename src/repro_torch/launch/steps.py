"""Step functions of the LM stack and the shapes of their inputs.

Counterpart of the inference half of ``repro/launch/steps.py``:
``make_prefill_step`` and ``make_decode_step`` (the programs a server
runs), ``prefill_batch_specs`` and ``decode_batch_specs`` (their batches)
and ``abstract_decode_cache`` (the KV cache), as shapes and dtypes.  The
train steps wait for the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import pytree as pt
from repro_torch.models import transformer


@dataclass(frozen=True)
class ShapeDtype:
    """A tensor's shape and dtype (the reference's ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape
                        ) -> Dict[str, ShapeDtype]:
    transformer._check_ported(cfg)
    return {"tokens": ShapeDtype((shape.global_batch, shape.seq_len),
                                 torch.int32)}


def decode_batch_specs(cfg: ModelConfig, shape: InputShape
                       ) -> Dict[str, ShapeDtype]:
    return {"tokens": ShapeDtype((shape.global_batch, 1), torch.int32),
            "t": ShapeDtype((), torch.int32)}


def abstract_decode_cache(cfg: ModelConfig, shape: InputShape,
                          dtype=torch.bfloat16) -> dict:
    """The decode cache's shapes: KV caches in the activation dtype."""
    cache_len = transformer.effective_cache_len(cfg, shape.seq_len)
    specs = transformer.decode_cache_specs(cfg, shape.global_batch,
                                           cache_len)
    return pt.tmap(lambda s: ShapeDtype(s.shape, dtype), specs)


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def step(params, batch):
        return transformer.prefill(params, batch, cfg)
    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def step(params, batch, cache):
        return transformer.decode_step(params, batch, cache, cfg)
    return step
