"""Elliptical slice sampling (Murray, Adams & MacKay 2010).

Counterpart of the JAX package's ``inference/mcmc/ess.py``. ``ess_kernel``
targets densities ``p(q) ∝ N(q; 0, Σ) · exp(loglik(q))``: the Gaussian
prior is handled exactly by the ellipse, only ``loglik`` is evaluated in
the angle-shrinking loop. Chains are the leading dimension of the state;
the shrinking loop runs while any chain is still looking (one host read a
round, at most ``max_shrink`` rounds) and masks the chains that are done.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .hmc import as_draws, chain_slice, select
from .sample import chain_values

__all__ = ["ESSState", "ess_init", "ess_kernel", "run_ess"]


class ESSState(NamedTuple):
    q: torch.Tensor       # (C, dim)
    loglik: torch.Tensor  # (C,)


def ess_init(loglik_values: Callable, q0: torch.Tensor) -> ESSState:
    """``loglik_values(q, active) -> (C,)`` (``sample.chain_values``)."""
    return ESSState(q0, loglik_values(q0, None))


def ess_kernel(loglik_values: Callable, sample_prior: Callable, max_shrink: int = 64):
    """One elliptical-slice transition per chain.

    ``sample_prior(generator) -> (dim,)`` draws from the zero-mean Gaussian
    prior (e.g. ``L @ randn`` for a GP prior with ``L = chol(K)``), one draw
    a call; a nonzero prior mean is handled by passing ``q − mean`` through
    the ellipse at the call site. Returns ``step(draws, state) ->
    (state, num_evals (C,))``; ``draws`` is a draws object
    (``hmc.GeneratorDraws``) or a generator.
    """

    def step(draws, state: ESSState):
        draws = as_draws(draws)
        q = state.q
        n, dev = q.shape[0], q.device

        nu = draws.prior(sample_prior, q)
        threshold = state.loglik + torch.log(draws.level_uniform(q))
        theta = draws.angle_uniform(q) * (2.0 * math.pi)
        lo, hi = theta - 2.0 * math.pi, theta

        def propose(theta, active):
            qp = q * torch.cos(theta)[:, None] + nu * torch.sin(theta)[:, None]
            return qp, loglik_values(qp, active)

        qp, ll = propose(theta, None)
        done = ll > threshold
        count = torch.ones(n, dtype=torch.int64, device=dev)
        for _ in range(max_shrink - 1):
            looking = ~done
            host = looking.tolist()
            if not any(host):
                break
            # shrink the bracket toward 0 and redraw
            lo = torch.where(looking & (theta < 0.0), theta, lo)
            hi = torch.where(looking & (theta >= 0.0), theta, hi)
            theta = torch.where(looking, draws.shrink_uniform(q, looking) * (hi - lo) + lo, theta)
            q_new, ll_new = propose(theta, host)
            qp = select(looking, q_new, qp)
            ll = torch.where(looking, ll_new, ll)
            count = count + looking
            done = done | (looking & (ll_new > threshold))
        # max_shrink exhausted without acceptance → keep the current state
        return ESSState(select(done, qp, q), torch.where(done, ll, state.loglik)), count

    return step


def run_ess(loglik: Callable, sample_prior: Callable, q0: torch.Tensor, generator, *,
            num_samples: int = 1000, num_burnin: int = 100, num_chains: int | None = None,
            chain_eval: str = "vmap", mesh=None, mesh_axis: str = "dp"):
    """Run ESS; ``q0`` is (dim,) or (num_chains, dim); ``loglik`` maps one
    (dim,) position to a scalar, evaluated over the chains by
    ``chain_eval`` (``"vmap"`` or ``"loop"``, as in ``run_mcmc``);
    ``generator`` is a ``torch.Generator`` or a seed on q0's device, or a
    draws object. Returns (samples (chains, draws, dim), logliks (chains, draws)).
    ``mesh``: optional ``DeviceMesh``; the chains are sharded over
    ``mesh_axis`` as in ``run_mcmc``: each rank runs and returns its own
    block of chains, with no collective."""
    if num_samples < 1:
        raise ValueError(f"num_samples must be at least 1, got {num_samples}")
    if num_chains is None:
        q0 = q0[None, :]
    elif q0.ndim == 1:
        q0 = q0.expand((num_chains,) + q0.shape)
    start, stop, draws = chain_slice(as_draws(generator, q0.device), q0.shape[0], mesh,
                                     mesh_axis)
    q0 = q0[start:stop]
    values = chain_values(loglik, chain_eval)
    kernel = ess_kernel(values, sample_prior)
    with torch.no_grad():
        state = ess_init(values, q0.detach().clone())
        for _ in range(num_burnin):
            state, _ = kernel(draws, state)
        qs, lls = [], []
        for _ in range(num_samples):
            state, _ = kernel(draws, state)
            qs.append(state.q)
            lls.append(state.loglik)
    return torch.stack(qs, dim=1), torch.stack(lls, dim=1)
