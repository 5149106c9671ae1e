"""Minimal optimizer library over parameter trees.

Counterpart of ``repro/optim/optimizers.py``.  ``Optimizer`` is an
(init, update) pair::

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = pt.add(params, updates)

Used by the server step (``server_opt``: FedAvgM's momentum, adam).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.core import pytree as pt


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def sgd(learning_rate: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return pt.scale(grads, -learning_rate), state

    return Optimizer(init, update)


def momentum(learning_rate: float, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return pt.zeros_like(params)

    def update(grads, m, params=None):
        m = pt.axpy(beta, m, grads)
        g = pt.axpy(beta, m, grads) if nesterov else m
        return pt.scale(g, -learning_rate), m

    return Optimizer(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        dev = pt.leaves(params)[0].device
        return {"m": pt.zeros_like(params), "v": pt.zeros_like(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        m = pt.tmap(lambda mi, g: b1 * mi + (1 - b1) * g, state["m"], grads)
        v = pt.tmap(lambda vi, g: b2 * vi + (1 - b2) * g * g,
                    state["v"], grads)
        tf = t.to(torch.float32)
        mh = pt.scale(m, 1.0 / (1 - b1 ** tf))
        vh = pt.scale(v, 1.0 / (1 - b2 ** tf))
        upd = pt.tmap(
            lambda mi, vi: -learning_rate * mi / (torch.sqrt(vi) + eps),
            mh, vh)
        if weight_decay and params is not None:
            upd = pt.tmap(
                lambda u, p: u - learning_rate * weight_decay * p,
                upd, params)
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)
