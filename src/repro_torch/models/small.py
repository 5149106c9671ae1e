"""Multinomial logistic regression, the paper's convex model (§V).

Counterpart of ``repro/models/small.py:24-45``.  Params are
``{"w": (d, C), "b": (C,)}``; a batch is ``{"x": (B, d), "y": (B,)}``
with integer labels.  ``logreg_loss`` is written so that
``torch.func.vmap``/``grad`` apply to it.
"""
from __future__ import annotations

import torch

from repro_torch.models.param import ParamSpec


def logreg_specs(num_features: int, num_classes: int) -> dict:
    return {
        "w": ParamSpec((num_features, num_classes), ("d_model", None),
                       init="zeros"),
        "b": ParamSpec((num_classes,), (None,), init="zeros"),
    }


def logreg_logits(params, x):
    return x @ params["w"] + params["b"]


def logreg_loss(params, batch) -> torch.Tensor:
    logits = logreg_logits(params, batch["x"])
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, batch["y"].long().unsqueeze(1))[:, 0]
    return nll.mean()


def logreg_accuracy(params, batch) -> torch.Tensor:
    pred = torch.argmax(logreg_logits(params, batch["x"]), dim=-1)
    return (pred == batch["y"]).float().mean()
