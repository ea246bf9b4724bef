"""Hyperparameter training loops: MLE-II with ``torch.optim``.

Counterpart of the JAX package's ``inference/training.py`` (reference:
examples/0-intro-1d/script.jl:369-426, examples/1-mauna-loa/script.jl:
210-230). The parameter tree is tagged with bijectors
(``abstractgps_tpu_torch.params``), the loss is ``-logpdf`` or ``-elbo``
built from the constrained tree each step, and its gradient flows back
to the raw tensors through the kernels' backward passes. The per-step loss
history is written on the device: no host read per step (L-BFGS's line
search and its gradient-norm stop read the host anyway).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import params as P
from ..utils.profiling import span

__all__ = ["FitResult", "fit", "fit_lbfgs", "nlml", "neg_elbo"]

_MAX_LINESEARCH = 25  # evaluations per L-BFGS line search (torch's default)


class FitResult(NamedTuple):
    """Optimised (still-tagged) parameter tree + per-step loss history."""

    params: object
    history: torch.Tensor


def nlml(build_fx: Callable, x, y) -> Callable:
    """Negative log marginal likelihood objective for MLE-II.

    ``build_fx(theta, x)`` must return a FiniteGP for a *constrained*
    parameter tree theta (the rebuild-kernel-from-θ pattern,
    examples/0-intro-1d/script.jl:111-117). Returns ``loss(raw_theta)``.
    """

    def loss(raw_theta):
        fx = build_fx(P.constrain(raw_theta), x)
        return -fx.logpdf(y)

    return loss


def neg_elbo(build_parts: Callable, x, y) -> Callable:
    """Negative Titsias ELBO objective for sparse VI.

    ``build_parts(theta, x)`` must return ``(vfe, fx)`` — the VFE wrapper
    around the inducing projection and the data projection — for a
    constrained theta (reference loop: examples/0-intro-1d/script.jl:384-402).
    Returns ``loss(raw_theta)``.
    """
    from ..models.sparse import elbo

    def loss(raw_theta):
        vfe, fx = build_parts(P.constrain(raw_theta), x)
        return -elbo(vfe, fx, y)

    return loss


def _fresh(theta0):
    """A copy of the tree whose raw tensors are new leaves (``theta0`` is
    left as it was, as the JAX loops leave their input)."""
    return P.with_leaves(theta0, [t.detach().clone().requires_grad_()
                                  for t in P.leaves(theta0)])


def _history(n: int, leaves) -> torch.Tensor:
    ref = leaves[0]
    return torch.full((n,), float("nan"), dtype=ref.dtype, device=ref.device)


def fit(
    loss: Callable,
    theta0,
    *,
    optimizer: Callable | None = None,
    num_steps: int = 500,
    learning_rate: float = 1e-2,
) -> FitResult:
    """Minimise ``loss(raw_theta)`` with a first-order ``torch.optim``
    optimizer: ``optimizer(leaves)`` builds it over the tree's raw tensors
    (default ``torch.optim.Adam(leaves, lr=learning_rate)``, the update and
    defaults of ``optax.adam``). ``history[i]`` is the loss before step i.
    Each step is a ``fit.step`` span (a unit of ``profiling.recording``)."""
    theta = _fresh(theta0)
    leaves = P.leaves(theta)
    opt = (optimizer or (lambda ps: torch.optim.Adam(ps, lr=learning_rate)))(leaves)
    history = _history(num_steps, leaves)
    for i in range(num_steps):
        with span("fit.step"):
            with span("fit.zero_grad"):
                opt.zero_grad(set_to_none=True)
            with span("fit.loss"):
                val = loss(theta)
            with span("fit.backward"):
                val.backward()
            with span("fit.optimizer"):
                opt.step()
            with span("fit.history"):
                history[i] = val.detach()
    return FitResult(theta, history)


def fit_lbfgs(
    loss: Callable,
    theta0,
    *,
    num_steps: int = 100,
    memory_size: int = 20,
    tol: float = 1e-8,
) -> FitResult:
    """Minimise ``loss(raw_theta)`` with L-BFGS and a strong-Wolfe line
    search (``torch.optim.LBFGS``), one iteration per step, stopping after
    ``num_steps`` iterations or once the gradient's 2-norm at the current
    point is ≤ ``tol``.

    ``FitResult.history`` is the per-iteration loss trace of length
    ``num_steps``: entry i is the loss at the start of iteration i; entries
    at indices >= the iteration count are backfilled with the final loss.
    A NaN loss met during the run stays visible: the iteration that meets
    one (at its start or inside its line search, which cannot bracket a
    NaN) records NaN, leaves the parameters where the iteration began, and
    ends the run; a NaN gradient ends it too.
    """
    theta = _fresh(theta0)
    leaves = P.leaves(theta)
    # one iteration per step(); max_eval bounds the line search of that
    # iteration (torch derives it from max_iter, which would leave none)
    opt = torch.optim.LBFGS(leaves, lr=1.0, max_iter=1, max_eval=1 + _MAX_LINESEARCH,
                            history_size=memory_size, tolerance_grad=0.0,
                            tolerance_change=0.0, line_search_fn="strong_wolfe")
    first = {}

    def closure():
        opt.zero_grad(set_to_none=True)
        val = loss(theta)
        val.backward()
        if not first:
            grads = [p.grad for p in leaves if p.grad is not None]
            first["val"] = val.detach()
            first["gnorm"] = torch.linalg.vector_norm(torch.cat([g.reshape(-1) for g in grads]))
        if not bool(torch.isfinite(val)):
            raise _NonFinite
        return val

    history = _history(num_steps, leaves)
    it = 0
    while it < num_steps:
        first.clear()
        start = [p.detach().clone() for p in leaves]
        try:
            opt.step(closure)
        except _NonFinite:
            with torch.no_grad():
                for p, s0 in zip(leaves, start):
                    p.copy_(s0)
            history[it] = float("nan")
            it += 1
            break
        history[it] = first["val"]
        it += 1
        if not bool(first["gnorm"] > tol):  # also stops on a NaN gradient
            break
    with torch.no_grad():
        final = loss(theta).detach()
    # backfill ONLY the unvisited tail: a NaN met during the run stays
    idx = torch.arange(num_steps, device=history.device)
    history = torch.where(idx >= it, final.to(history.dtype), history)
    return FitResult(theta, history)


class _NonFinite(Exception):
    """A loss evaluation of ``fit_lbfgs`` gave NaN or ±inf."""
