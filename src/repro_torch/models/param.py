"""Parameter specs, initialisation, and the bridge to numpy.

Counterpart of ``repro/models/param.py`` (``ParamSpec``, ``init_params``).
The reference draws its initial values from ``jax.random``; the port
draws from a ``torch.Generator``, so the two agree exactly only for the
``zeros``/``ones`` initialisers (logistic regression is all zeros).
Parity tests carry the reference's values across with
:func:`params_from_numpy` / :func:`params_to_numpy`, which also move
algorithm state (``g_prev``, controls, ``center``, optimizer state).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import pytree as pt
from repro_torch.device import resolve_device

Axis = Optional[str]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Axis, ...]
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float = 0.0           # 0 -> fan-in default

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def _init_one(spec: ParamSpec, gen: torch.Generator, dtype, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    draw = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                       device=gen.device)
    if spec.init == "embed":
        return (draw * 0.02).to(dtype=dtype, device=device)
    # fan-in scaled normal; the output dim is the last axis by convention
    fan_in = 1
    for s, a in zip(spec.shape, spec.axes):
        if a not in ("layers", "experts") and s > 1:
            fan_in *= s
    if len(spec.shape) >= 2:
        fan_in //= max(1, spec.shape[-1])
    scale = spec.scale or 1.0 / math.sqrt(max(1, fan_in))
    return (draw * scale).to(dtype=dtype, device=device)


def init_params(spec_tree, generator: torch.Generator,
                dtype=torch.float32, device=None):
    """Real parameters for ``spec_tree``, drawn from ``generator`` on
    its device (a CPU generator gives a seed the same values on every
    device) and moved to ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return pt.tmap(lambda s: _init_one(s, generator, dtype, dev), spec_tree)


def param_count(spec_tree) -> int:
    """Number of scalars in ``spec_tree``, from the specs alone."""
    return int(sum(math.prod(s.shape) for s in pt.leaves(spec_tree)))


def params_from_numpy(tree, device=None):
    """A tree of numpy arrays (or numpy scalars) as tensors on
    ``device`` -- how the reference's params and state enter the port."""
    dev = resolve_device(device)
    return pt.tmap(lambda x: torch.from_numpy(np.array(x)).to(dev), tree)


def params_to_numpy(tree):
    """A tree of tensors as numpy arrays on the host."""
    return pt.tmap(lambda x: x.detach().cpu().numpy()
                   if isinstance(x, torch.Tensor) else np.asarray(x), tree)
