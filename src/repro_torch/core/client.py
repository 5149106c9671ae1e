"""Client-side local solvers: per-device (looped reference) and batched.

Counterpart of ``repro/core/client.py``.  Every algorithm reduces to E
epochs of minibatch SGD on a perturbed local objective
``F_k(w) + <corr, w - w0> + (mu/2)||w - w0||^2``.

``make_local_solver`` is the looped reference: one device, the plain
4-op tree update, gradients from ``torch.func.grad``.  The batched
solvers advance all K selected devices in lockstep over stacked batches
with a ``(K, nb)`` validity mask (masked steps are identity steps, so a
device with fewer batches follows exactly its own trajectory).

Solver modes (``make_batched_solver(..., solver=...)``):

- ``"flat"`` -- per-device gradients from
  ``torch.func.vmap(torch.func.grad(loss))``, then ONE masked update
  launch (K1) per step over the whole-tree flat pack;
- ``"per_leaf"`` -- the same gradients, one update launch (K4) per leaf,
  then the select; bitwise equal to ``"flat"``;
- ``"fused_step"`` / ``"fused_epoch"`` -- the model's registered
  :class:`SolverSpec` kernels: one launch per step (K3), or one per
  whole local solve (K2); atol 1e-5 against the reference, not bitwise;
- ``"auto"`` -- the fused kernels when the tensors are on the card and a
  registered spec accepts the workload, else ``"flat"`` (as the
  reference keeps the CPU on flat).

For the paper's analysis (§IV), ``make_exact_solver`` minimizes the
subproblem nearly exactly (long full-batch GD) and ``gamma_inexactness``
measures how far a practical solve lands from it (Definition 1).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad, vmap

from repro_torch.core import pytree as pt

#: Valid ``make_batched_solver`` modes / ``FederatedConfig.local_solver``.
SOLVER_MODES = ("auto", "flat", "per_leaf", "fused_step", "fused_epoch")


class SolverSpec(NamedTuple):
    """Fused-solver registration for one loss function.

    - ``select(w0, batches, num_epochs)``: shape gate; returns
      ``"fused_epoch"``, ``"fused_step"`` or ``None`` (generic flat path).
    - ``make_step(eta)``: builds ``step(w, batch, corr, w0, mu, mask)``
      over K-stacked trees.
    - ``make_epoch(eta, num_epochs)``: builds
      ``solve(w0, corr, mu, batches, step_mask)`` running the whole
      E-epoch solve in one launch.
    """

    name: str
    summary: str
    select: Callable[[Any, Any, int], Optional[str]]
    make_step: Callable
    make_epoch: Optional[Callable]


_SOLVERS: dict = {}


def register_local_solver(loss_fn: Callable, spec: SolverSpec) -> None:
    """Register ``spec`` as the fused solver for ``loss_fn`` (keyed by
    function identity)."""
    _SOLVERS[loss_fn] = spec


def local_solver_spec(loss_fn: Callable) -> Optional[SolverSpec]:
    """The registered :class:`SolverSpec` for ``loss_fn``, or None."""
    if not _SOLVERS:
        from repro_torch.kernels import local_solve
        local_solve.register()
    return _SOLVERS.get(loss_fn)


class LocalResult(NamedTuple):
    """One local solve's outcome: per-device leaves in the looped path,
    K-stacked leaves from the batched solvers."""

    params: Any           # w_k^t
    delta: Any            # w_k^t - w^{t-1}
    num_steps: Any


def _batch_weight(batches) -> torch.Tensor:
    """Per-batch gradient weights over a ``(nb, ...)`` stack: the
    example-mask sums when the data layer provides ``"w"``, else 1."""
    if isinstance(batches, dict) and "w" in batches:
        w = batches["w"]
        return w.reshape(w.shape[0], -1).sum(dim=1)
    n = pt.leaves(batches)[0].shape[0]
    return torch.ones(n, device=pt.leaves(batches)[0].device)


def make_local_solver(loss_fn: Callable, *, learning_rate: float,
                      num_epochs: int, with_cutoff: bool = False) -> Callable:
    """The looped reference solver for one device.

    ``solve(w0, corr, mu, batches) -> LocalResult`` where ``batches``
    has leaves ``(num_batches, batch, ...)``; each step applies
    ``w -= lr * (grad F_k(w) + corr + mu (w - w0))`` as plain tree ops.

    ``with_cutoff=True`` builds the scenario variant
    ``solve(w0, corr, mu, batches, max_steps)``: the device stops after
    ``max_steps`` steps (partial work, partial-credit stragglers), which
    equals the reference's identity steps past the cutoff.
    """
    grad_fn = grad(loss_fn)

    def solve_body(w0, corr, mu, batches, max_steps=None) -> LocalResult:
        nb = pt.leaves(batches)[0].shape[0]
        total = num_epochs * nb
        steps = total if max_steps is None else min(total, int(max_steps))
        w = w0
        for t in range(steps):
            g = grad_fn(w, pt.index(batches, t % nb))
            g = pt.add(g, corr)
            g = pt.add(g, pt.scale(pt.sub(w, w0), mu))
            w = pt.sub(w, pt.scale(g, learning_rate))
        return LocalResult(w, pt.sub(w, w0), steps)

    if with_cutoff:
        return solve_body
    return lambda w0, corr, mu, batches: solve_body(w0, corr, mu, batches)


def _weighted_grad_mean(loss_fn, w, batches, weights):
    """``sum_j weights[j] grad(w, batch_j) / max(sum weights, 1e-9)``."""
    g = vmap(grad(loss_fn), in_dims=(None, 0))(w, batches)
    wsum = weights.sum()
    gsum = pt.tmap(lambda x: (x * weights.reshape(
        weights.shape + (1,) * (x.ndim - 1))).sum(dim=0), g)
    return pt.scale(gsum, 1.0 / torch.clamp(wsum, min=1e-9))


def make_grad_fn(loss_fn: Callable) -> Callable:
    """Full local gradient over all of a device's (padded) batches: the
    weighted mean of the per-batch gradients (FedDANE phase A)."""

    def full_grad(w, batches):
        return _weighted_grad_mean(loss_fn, w, batches,
                                   _batch_weight(batches))

    return full_grad


def make_batched_grad_fn(loss_fn: Callable) -> Callable:
    """Full local gradients for a device-stacked selection:
    ``grads(w, batches, valid)`` with a leading K axis, per device the
    weighted mean over its *valid* batches."""

    def one(w, batches, valid):
        return _weighted_grad_mean(loss_fn, w, batches,
                                   _batch_weight(batches) * valid)

    def grads(w, batches, valid):
        return vmap(one, in_dims=(None, 0, 0))(w, batches, valid)

    return grads


def make_eval_loss(loss_fn: Callable) -> Callable:
    """Per-device eval loss: the mean batch loss over the device's
    ``(nb, batch, ...)`` stack, as a 0-dim tensor on the device."""
    per_batch = vmap(loss_fn, in_dims=(None, 0))

    def f(p, b):
        return per_batch(p, b).sum() / pt.leaves(b)[0].shape[0]

    return f


def _resolve_solver_mode(solver: str, loss_fn: Callable, w0, batches,
                         num_epochs: int) -> str:
    """Dispatch of the requested solver mode.  Explicit fused requests
    validate against the registry and shape gate with a clear error;
    ``"auto"`` falls back to flat silently."""
    if solver not in SOLVER_MODES:
        raise ValueError(
            f"unknown solver mode {solver!r}; pick one of {SOLVER_MODES}")
    if solver in ("flat", "per_leaf"):
        return solver
    spec = local_solver_spec(loss_fn)
    picked = spec.select(w0, batches, num_epochs) if spec else None
    if solver == "auto":
        on_card = pt.leaves(w0)[0].device.type == "cuda"
        if spec is None or picked is None or not on_card:
            return "flat"
        return picked
    if spec is None:
        raise ValueError(
            f"solver={solver!r} but no SolverSpec is registered for "
            f"{getattr(loss_fn, '__name__', loss_fn)!r} "
            f"(register_local_solver)")
    if picked is None:
        raise ValueError(
            f"solver={solver!r}: registered spec {spec.name!r} rejects "
            f"this workload's shapes; use solver='flat'")
    if solver == "fused_epoch" and spec.make_epoch is None:
        raise ValueError(
            f"spec {spec.name!r} has no whole-epoch kernel; "
            f"use solver='fused_step'")
    return solver


def _epoch_step_mask(valid, num_epochs: int, steps_limit=None):
    """Per-step keep mask (K, E*nb) in scan order (epochs outer, batches
    inner): the closed form of the generic solver's running
    ``done < steps_limit`` predicate."""
    v_steps = valid.repeat(1, num_epochs)
    if steps_limit is None:
        return v_steps
    done_before = torch.cumsum(v_steps, dim=1) - v_steps
    return v_steps * (done_before < steps_limit[:, None])


def make_batched_solver(loss_fn: Callable, *, learning_rate: float,
                        num_epochs: int, with_cutoff: bool = False,
                        solver: str = "auto") -> Callable:
    """Device-parallel E-epoch SGD solver for DANE-type subproblems.

    ``solve(w0, corr, mu, batches, valid) -> LocalResult`` where ``w0``
    is the unstacked anchor, ``corr`` a K-stacked correction,
    ``batches`` has leaves ``(K, nb, batch, ...)`` and ``valid`` is the
    float ``(K, nb)`` mask.  Returned leaves keep the leading K axis.

    ``with_cutoff=True`` builds the scenario variant
    ``solve(w0, corr, mu, batches, valid, steps_limit)``: device k stops
    after ``steps_limit[k]`` of its *valid* steps.  The cap folds into
    the step mask, so every mode -- the fused kernels included -- runs
    the truncated trajectory the looped cutoff solver gives.
    """
    from repro_torch.kernels import flatpack
    from repro_torch.kernels import ops as kops

    grad_fn = vmap(grad(loss_fn))

    def solve_body(w0, corr, mu, batches, valid,
                   steps_limit=None) -> LocalResult:
        K, nb = valid.shape
        mode = _resolve_solver_mode(solver, loss_fn, w0, batches,
                                    num_epochs)
        anchor = pt.tmap(
            lambda x: x.expand((K,) + x.shape).contiguous(), w0)
        done = num_epochs * valid.sum(dim=1)
        taken = (done if steps_limit is None
                 else torch.minimum(done, steps_limit)).to(torch.int32)

        if mode == "fused_epoch":
            spec = local_solver_spec(loss_fn)
            solve_fn = spec.make_epoch(learning_rate, num_epochs)
            mask = _epoch_step_mask(valid, num_epochs, steps_limit)
            w = solve_fn(w0, pt.tmap(torch.Tensor.contiguous, corr), mu,
                         batches, mask)
            return LocalResult(w, pt.sub(w, anchor), taken)

        if mode == "fused_step":
            step_fn = local_solver_spec(loss_fn).make_step(learning_rate)
        if mode == "flat":
            flat = kops.FlatUpdate(flatpack.flat_spec(w0), corr, w0, K)
        else:
            corr = pt.tmap(torch.Tensor.contiguous, corr)

        w = anchor
        so_far = torch.zeros_like(done)
        for _ in range(num_epochs):
            for j in range(nb):
                batch = pt.tmap(lambda x: x[:, j], batches)
                v = valid[:, j]
                # the cap counts valid steps
                m = v if steps_limit is None else v * (so_far < steps_limit)
                if mode == "fused_step":
                    w = step_fn(w, batch, corr, w0, mu, m)
                elif mode == "flat":
                    w = flat.step(grad_fn(w, batch), learning_rate, mu, m)
                else:                               # per_leaf
                    g = grad_fn(w, batch)
                    w = kops.dane_update_masked(
                        w, g, corr, anchor, learning_rate, mu, m)
                if steps_limit is not None:
                    so_far = so_far + v
        return LocalResult(w, pt.sub(w, anchor), taken)

    if with_cutoff:
        return solve_body
    return lambda w0, corr, mu, batches, valid: \
        solve_body(w0, corr, mu, batches, valid)


def make_exact_solver(loss_fn: Callable, *, learning_rate: float,
                      num_iters: int = 2000) -> Callable:
    """Near-exact subproblem minimizer (long full-batch GD) for measuring
    the γ-inexactness of the practical solver (Definition 1).

    ``solve(w0, corr, mu, batches) -> w``: ``num_iters`` steps of
    ``w -= lr * (grad F_k(w) + corr + mu (w - w0))`` with the full local
    gradient (the weighted mean over the device's batches)."""
    full_grad = make_grad_fn(loss_fn)

    def solve(w0, corr, mu, batches):
        w = w0
        for _ in range(num_iters):
            g = pt.add(full_grad(w, batches), corr)
            g = pt.add(g, pt.scale(pt.sub(w, w0), mu))
            w = pt.sub(w, pt.scale(g, learning_rate))
        return w

    return solve


def gamma_inexactness(w_inexact, w_exact, w0) -> torch.Tensor:
    """Definition 1: ||w - w_exact|| <= gamma ||w_exact - w0||."""
    denom = pt.norm(pt.sub(w_exact, w0))
    return pt.norm(pt.sub(w_inexact, w_exact)) / torch.clamp(denom,
                                                              min=1e-12)
