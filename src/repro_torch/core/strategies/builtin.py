"""The built-in algorithm specs (paper Alg. 1 & 2, §V-C variants, and
beyond-paper strategies), one :func:`register_algorithm` call each.

Counterpart of ``repro/core/strategies/builtin.py``, rule for rule.
Every rule is written in the polymorphic-shape convention of
``spec.py``: plain ``repro_torch.core.pytree`` ops that serve both the
host loop (per-device trees) and the batched round (K-stacked trees)
through broadcasting.
"""
from __future__ import annotations

from repro_torch.core import pytree as pt
from repro_torch.core.strategies.spec import (AlgorithmSpec, bscale,
                                              register_algorithm)


# -- correction rules -------------------------------------------------------

def _dane_correction(ctx):
    """Alg. 2 eq. 3: corr = decay * (g_t - grad F_k(w^{t-1})); the
    pipelined variant feeds the *stale* g as ``g_global``."""
    return pt.scale(pt.sub(ctx.g_global, ctx.g_local), ctx.decay)


def _scaffold_correction(ctx):
    """Karimireddy et al.: corr = c - c_k (round-start server control)."""
    return pt.sub(ctx.c_server, ctx.c_local)


def _sdane_correction(ctx):
    """Jiang et al. stabilized DANE: the DANE gradient correction plus
    the anchor shift mu * (w^{t-1} - v^t), which re-centers the solver's
    proximal term at the auxiliary center v^t without touching the
    solver itself (the prox gradient mu*(w - w0) + mu*(w0 - v) equals
    mu*(w - v))."""
    return pt.add(pt.sub(ctx.g_global, ctx.g_local),
                  pt.scale(pt.sub(ctx.w0, ctx.center), ctx.mu))


# -- state-update rules -----------------------------------------------------

def _scaffold_control_update(ctx):
    """Option II control refresh:
    c_k' = c_k - c + (w^{t-1} - w_k) / (steps * lr)."""
    return pt.add(pt.sub(ctx.c_local, ctx.c_server),
                  bscale(pt.sub(ctx.w0, ctx.w_new), ctx.inv_steps))


def _sdane_center_update(center, w_new, cfg):
    """Stabilized center sequence: v^{t+1} = v^t + lam (w^t - v^t) with
    lam = cfg.center_lr in (0, 1]; lam = 1 collapses S-DANE to FedDANE."""
    return pt.add(center, pt.scale(pt.sub(w_new, center), cfg.center_lr))


def _correction_decay(cfg, t):
    """decay^t (§V-C) for round index ``t``."""
    return cfg.correction_decay ** t


# -- the registry -----------------------------------------------------------

FEDAVG = register_algorithm(AlgorithmSpec(
    name="fedavg",
    summary="McMahan et al. Alg. 1: local SGD, unweighted server mean",
    comm_per_round=1, num_selections=1, use_mu=False))

FEDPROX = register_algorithm(AlgorithmSpec(
    name="fedprox",
    summary="Li et al.: FedAvg plus the proximal term mu/2 ||w - w0||^2",
    comm_per_round=1, num_selections=1))

FEDDANE = register_algorithm(AlgorithmSpec(
    name="feddane",
    summary="Alg. 2: S1 gradient gather, S2 corrected proximal solves "
            "(two communication rounds per update)",
    comm_per_round=2, num_selections=2, grad_source="fresh",
    local_grad=True, correction=_dane_correction))

INEXACT_DANE = register_algorithm(AlgorithmSpec(
    name="inexact_dane",
    summary="Reddi et al.: FedDANE at full participation (one shared "
            "gradient pass serves both phases)",
    comm_per_round=2, num_selections=0, grad_source="fresh",
    local_grad=True, correction=_dane_correction))

FEDDANE_DECAYED = register_algorithm(AlgorithmSpec(
    name="feddane_decayed",
    summary="§V-C: FedDANE with the correction scaled by decay^t "
            "(anneals into FedProx)",
    comm_per_round=2, num_selections=2, grad_source="fresh",
    local_grad=True, correction=_dane_correction,
    decay=_correction_decay))

FEDDANE_PIPELINED = register_algorithm(AlgorithmSpec(
    name="feddane_pipelined",
    summary="§V-C: one round per update — solves use the previous "
            "round's stale g while fresh gradients refresh it",
    comm_per_round=1, num_selections=1, grad_source="stale",
    local_grad=True, updates_g_prev=True, correction=_dane_correction,
    state_fields=("g_prev",)))

SCAFFOLD = register_algorithm(AlgorithmSpec(
    name="scaffold",
    summary="Karimireddy et al.: control-variate corrections "
            "(option II control refresh)",
    comm_per_round=1, num_selections=1, use_mu=False,
    correction=_scaffold_correction,
    control_update=_scaffold_control_update,
    state_fields=("controls",)))

FEDAVGM = register_algorithm(AlgorithmSpec(
    name="fedavgm",
    summary="Hsu et al.: FedAvg with server momentum over the "
            "round's pseudo-gradient w^{t-1} - mean_k w_k",
    comm_per_round=1, num_selections=1, use_mu=False,
    server_opt="momentum"))

SDANE = register_algorithm(AlgorithmSpec(
    name="sdane",
    summary="Jiang et al. stabilized proximal point: DANE corrections "
            "with the prox anchored at an auxiliary center sequence",
    comm_per_round=2, num_selections=2, grad_source="fresh",
    local_grad=True, correction=_sdane_correction,
    center_update=_sdane_center_update, state_fields=("center",)))

ONE_SHOT = register_algorithm(AlgorithmSpec(
    name="one_shot",
    summary="EconML-style one-shot federation: every device trains a "
            "fully local model and the server aggregates exactly once "
            "(run with num_rounds=1 and a large local_epochs — see "
            "configs.base.one_shot_config); the extreme point of the "
            "communication-frugality axis",
    comm_per_round=1, num_selections=0, use_mu=False))
