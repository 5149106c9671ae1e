"""Small models of the paper's own experiments (§V).

Counterpart of ``repro/models/small.py``:

- multinomial logistic regression (synthetic(α,β), FEMNIST -- the convex
  case): params ``{"w": (d, C), "b": (C,)}``, a batch ``{"x": (B, d),
  "y": (B,)}`` with integer labels;
- the stacked-LSTM character model (Shakespeare -- non-convex): a batch
  ``{"tokens": (B, S), "labels": (B, S)}``;
- the LSTM sentiment classifier (Sent140 -- non-convex): a batch
  ``{"tokens": (B, S), "y": (B,)}``.

Every loss is written so that ``torch.func.vmap``/``grad`` apply to it
(the batched engine vmaps the gradient over K devices).  The LSTM's scan
over time is a Python loop over S; the gates are split in the order i,
f, g, o, with the forget gate's +1.0 bias inside its sigmoid, as the
reference has them.
"""
from __future__ import annotations

import torch

from repro_torch.models.param import ParamSpec


# ---------------------------------------------------------------------------
# Multinomial logistic regression
# ---------------------------------------------------------------------------

def logreg_specs(num_features: int, num_classes: int) -> dict:
    return {
        "w": ParamSpec((num_features, num_classes), ("d_model", None),
                       init="zeros"),
        "b": ParamSpec((num_classes,), (None,), init="zeros"),
    }


def logreg_logits(params, x):
    return x @ params["w"] + params["b"]


def _nll(logits, labels) -> torch.Tensor:
    """Mean negative log-likelihood of integer ``labels`` over every
    leading position of ``logits`` (..., C)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return nll.mean()


def logreg_loss(params, batch) -> torch.Tensor:
    return _nll(logreg_logits(params, batch["x"]), batch["y"])


def logreg_accuracy(params, batch) -> torch.Tensor:
    pred = torch.argmax(logreg_logits(params, batch["x"]), dim=-1)
    return (pred == batch["y"]).float().mean()


# ---------------------------------------------------------------------------
# LSTM cell + stacked models
# ---------------------------------------------------------------------------

def lstm_cell_specs(d_in: int, d_hidden: int) -> dict:
    return {
        "wx": ParamSpec((d_in, 4 * d_hidden), ("d_model", None)),
        "wh": ParamSpec((d_hidden, 4 * d_hidden), (None, None)),
        "b": ParamSpec((4 * d_hidden,), (None,), init="zeros"),
    }


def lstm_cell(params, carry, x_t):
    """One step: ``carry = (h, c)`` of (B, d_hidden), ``x_t`` (B, d_in);
    returns ``((h, c), h)``."""
    h, c = carry
    gates = x_t @ params["wx"] + h @ params["wh"] + params["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def lstm_run(params, xs):
    """xs: (B, S, d_in) -> (B, S, d_hidden), from a zero state."""
    B = xs.shape[0]
    dh = params["wh"].shape[0]
    zero = xs.new_zeros((B, dh))
    carry, hs = (zero, zero), []
    for t in range(xs.shape[1]):
        carry, h = lstm_cell(params, carry, xs[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1)


def _embed(table, tokens):
    return torch.nn.functional.embedding(tokens.long(), table)


def charlstm_specs(vocab: int, embed_dim: int = 8,
                   hidden: int = 256) -> dict:
    """Paper's Shakespeare model: 2-layer LSTM, 256 hidden, 8-dim embed."""
    return {
        "embed": ParamSpec((vocab, embed_dim), ("vocab", None),
                           init="embed"),
        "lstm1": lstm_cell_specs(embed_dim, hidden),
        "lstm2": lstm_cell_specs(hidden, hidden),
        "head_w": ParamSpec((hidden, vocab), (None, "vocab")),
        "head_b": ParamSpec((vocab,), ("vocab",), init="zeros"),
    }


def charlstm_logits(params, tokens):
    x = _embed(params["embed"], tokens)
    h = lstm_run(params["lstm1"], x)
    h = lstm_run(params["lstm2"], h)
    return h @ params["head_w"] + params["head_b"]


def charlstm_loss(params, batch) -> torch.Tensor:
    """Next-char prediction: batch = {tokens (B,S), labels (B,S)}; the
    mean over (B, S)."""
    return _nll(charlstm_logits(params, batch["tokens"]), batch["labels"])


def charlstm_accuracy(params, batch) -> torch.Tensor:
    pred = torch.argmax(charlstm_logits(params, batch["tokens"]), dim=-1)
    return (pred == batch["labels"]).float().mean()


def sentlstm_specs(vocab: int, embed_dim: int = 25,
                   hidden: int = 100, num_classes: int = 2) -> dict:
    """Paper's Sent140 model: embedding + LSTM + dense binary classifier."""
    return {
        "embed": ParamSpec((vocab, embed_dim), ("vocab", None),
                           init="embed"),
        "lstm1": lstm_cell_specs(embed_dim, hidden),
        "head_w": ParamSpec((hidden, num_classes), (None, None)),
        "head_b": ParamSpec((num_classes,), (None,), init="zeros"),
    }


def sentlstm_logits(params, tokens):
    x = _embed(params["embed"], tokens)
    h = lstm_run(params["lstm1"], x)
    return h[:, -1] @ params["head_w"] + params["head_b"]


def sentlstm_loss(params, batch) -> torch.Tensor:
    return _nll(sentlstm_logits(params, batch["tokens"]), batch["y"])


def sentlstm_accuracy(params, batch) -> torch.Tensor:
    pred = torch.argmax(sentlstm_logits(params, batch["tokens"]), dim=-1)
    return (pred == batch["y"]).float().mean()
