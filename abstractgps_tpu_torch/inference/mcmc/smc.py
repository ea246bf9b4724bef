"""Sequential Monte Carlo sampler with adaptive likelihood tempering.

Counterpart of the JAX package's ``inference/mcmc/smc.py`` (Del Moral,
Doucet & Jasra 2006; pymc-style adaptive tempering): tempered targets
``π_β ∝ prior · lik^β``; β advances adaptively so the incremental-weight
effective sample size stays at ``ess_target·N`` (bisection by a fixed
count of halvings, the JAX package's ``fori_loop``); systematic
resampling; rejuvenation by ``num_moves`` per-dimension-std-preconditioned
random-walk Metropolis steps at the current temperature. Particles are a
leading dimension; the stage loop is a host loop (one read a stage).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .hmc import as_draws, chain_slice
from .sample import chain_values

__all__ = ["SMCResult", "run_smc", "systematic_resample"]

_BISECTIONS = 26


class SMCResult(NamedTuple):
    particles: torch.Tensor     # (N, dim) final equal-weight particles
    log_evidence: torch.Tensor  # SMC estimate of log ∫ prior·lik
    num_stages: int             # tempering stages taken
    acceptance: torch.Tensor    # mean rejuvenation acceptance at the end


def systematic_resample(generator, log_weights: torch.Tensor) -> torch.Tensor:
    """Systematic resampling: (N,) int64 ancestor indices; ``generator`` is
    a ``torch.Generator`` or a draws object."""
    n = log_weights.shape[0]
    cum = torch.cumsum(torch.softmax(log_weights, dim=0), dim=0)
    u0 = as_draws(generator).resample_uniform(cum)
    pts = (u0 + torch.arange(n, dtype=cum.dtype, device=cum.device)) / n
    # rounding can leave cum[-1] slightly below pts[-1]; clip so the
    # ancestor index is well defined
    return torch.clamp(torch.searchsorted(cum, pts), 0, n - 1)


def _ess_fraction(log_w: torch.Tensor) -> torch.Tensor:
    lw = log_w - torch.logsumexp(log_w, dim=0)
    return torch.exp(-torch.logsumexp(2.0 * lw, dim=0)) / log_w.shape[0]


def run_smc(logprior: Callable, loglik: Callable, particles0: torch.Tensor, generator, *,
            ess_target: float = 0.5, num_moves: int = 8, max_stages: int = 50,
            proposal_scale: float | None = None, chain_eval: str = "vmap", mesh=None,
            mesh_axis: str = "dp") -> SMCResult:
    """Temper from the prior to the posterior.

    ``particles0``: (N, dim) draws from the prior. ``logprior``/``loglik``
    map one (dim,) position to a scalar, evaluated over the particles by
    ``chain_eval`` (``"vmap"`` or ``"loop"``, as in ``run_mcmc``);
    ``generator`` is a ``torch.Generator`` or a seed on the particles'
    device, or a draws object.

    ``mesh``: optional ``DeviceMesh``; the particles are sharded over
    ``mesh_axis`` (N must divide by its size) and propagated and weighted
    on their rank. A tempering stage takes three collectives, whatever N
    is: an all-gather of the log-likelihoods (every rank then bisects β,
    accumulates the normaliser and draws the resampling ancestors from the
    same uniform, identically), an all-gather of the particles (each rank
    takes its ancestors; the proposal scale is the std of the resampled
    set), and an all-reduce of the acceptance count. Every rank draws the
    full batch of random numbers and keeps its particles'. ``particles``
    of the result are this rank's.
    """
    n, dim = particles0.shape
    dtype, dev = particles0.dtype, particles0.device
    start, stop, draws = chain_slice(as_draws(generator, dev), n, mesh, mesh_axis)
    if mesh is None:
        def gather(t):
            return t
    else:
        from ...parallel.collectives import all_gather, all_reduce

        group = mesh.get_group(mesh_axis)

        def gather(t):
            return all_gather(t, group)
    scale = 2.38 / math.sqrt(dim) if proposal_scale is None else proposal_scale
    v_logprior = chain_values(logprior, chain_eval)
    v_loglik = chain_values(loglik, chain_eval)
    one = torch.ones((), dtype=dtype, device=dev)

    def next_beta(beta, ll):
        """Largest Δβ (≤ 1−β) with ESS(Δβ·ll) ≥ ess_target, by bisection."""
        def ess_at(b_new):
            return _ess_fraction((b_new - beta) * ll)

        lo, hi = beta, one
        for _ in range(_BISECTIONS):
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= ess_target
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        return torch.where(ess_at(one) >= ess_target, one, lo)

    def rejuvenate(particles, ll, lp, beta, std):
        """num_moves RWM steps at β, preconditioned per dimension by ``std``."""
        acc = torch.zeros((), dtype=dtype, device=dev)
        for _ in range(num_moves):
            prop = particles + scale * std * draws.proposal_normal(particles)
            ll_p = v_loglik(prop)
            lp_p = v_logprior(prop)
            log_ratio = (lp_p + beta * ll_p) - (lp + beta * ll)
            log_ratio = torch.where(torch.isnan(log_ratio), -torch.inf, log_ratio)
            u = torch.log(draws.move_uniform(particles))
            take = u < log_ratio
            particles = torch.where(take[:, None], prop, particles)
            ll = torch.where(take, ll_p, ll)
            lp = torch.where(take, lp_p, lp)
            acc = acc + take.to(dtype).sum() / n
        if mesh is not None:
            acc = all_reduce(acc, group)
        return particles, ll, lp, acc / num_moves

    with torch.no_grad():
        particles = particles0.detach()[start:stop]
        ll = v_loglik(particles)
        beta = torch.zeros((), dtype=dtype, device=dev)
        log_z = torch.zeros((), dtype=dtype, device=dev)
        accept = one
        stage = 0
        while stage < max_stages and float(beta) < 1.0:
            ll_all = gather(ll)
            beta_new = next_beta(beta, ll_all)
            log_w = (beta_new - beta) * ll_all
            log_z = log_z + torch.logsumexp(log_w, dim=0) - math.log(n)
            idx = systematic_resample(draws, log_w)
            resampled = gather(particles)[idx]
            std = torch.std(resampled, dim=0, unbiased=False) + 1e-8
            particles, ll = resampled[start:stop], ll_all[idx[start:stop]]
            lp = v_logprior(particles)
            particles, ll, lp, accept = rejuvenate(particles, ll, lp, beta_new, std)
            beta = beta_new
            stage += 1
    return SMCResult(particles, log_z, stage, accept)
