"""Exact GP-regression posterior with O(n²) sequential (online) updates.

Reference: src/exact_gpr_posterior.jl:1-91. ``posterior(fx, y)`` caches
``(α = C⁻¹δ, L = chol(K + Σy), x, δ = y − m)``; conditioning a posterior on
new data extends the cached Cholesky with ``update_chol`` instead of
refactorising. The posterior is itself an AbstractGP.

The posterior whitens through a ``covmat.Whitener`` of its L: on the kernel
path it keeps ``W = L⁻¹``, formed by the first predictive that whitens and
freed with the posterior, and every later ``V = L⁻¹ K(X, x*)`` is one
product with W instead of a solve, at any number of test points.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import covmat
from ..ops.distance import as_tensor
from ..ops.noise import noise_block_diag
from ..ops.precision import precise
from ..utils.profiling import span
from .finite_gp import FiniteGP
from .gp import AbstractGP

__all__ = ["PosteriorGP", "posterior", "ExactInference", "approx_log_evidence_exact"]


@dataclasses.dataclass(frozen=True)
class _ExactCache:
    alpha: torch.Tensor  # C⁻¹ δ, (N,)
    L: torch.Tensor      # chol(K + Σy), (N, N) lower
    x: torch.Tensor      # training inputs, (N, D)
    delta: torch.Tensor  # y − m, (N,)
    noise: object = None  # the Σy noise object


class PosteriorGP(AbstractGP):
    """Exact posterior process."""

    def __init__(self, prior: AbstractGP, data: _ExactCache):
        self.prior = prior
        self.data = data
        self._whiten = covmat.Whitener(data.L)  # B ↦ L⁻¹ B

    @precise
    def mean(self, x):
        # m(x*) + K(x*, X) α
        return self.prior.mean(x) + self.prior.cov(x, self.data.x) @ self.data.alpha

    @precise
    def cov(self, x, z=None):
        # K** − V'V with V = L⁻¹ K(X, x*) (the reference's Xt_invA_X, Xt_invA_Y)
        V = self._whiten(self.prior.cov(self.data.x, x))
        if z is None:
            return self.prior.cov(x) - covmat.symmetrize(V.T @ V)
        return self.prior.cov(x, z) - V.T @ self._whiten(self.prior.cov(self.data.x, z))

    @precise
    def var(self, x):
        # diagonal only; clamped at 0 against f32 cancellation
        V = self._whiten(self.prior.cov(self.data.x, x))
        return torch.clamp(self.prior.var(x) - covmat.diag_At_A(V), min=0.0)

    @precise
    def mean_and_cov(self, x):
        # one cross-gram shared between mean and cov
        K_Xx = self.prior.cov(self.data.x, x)
        m = self.prior.mean(x) + K_Xx.T @ self.data.alpha
        V = self._whiten(K_Xx)
        return m, self.prior.cov(x) - covmat.symmetrize(V.T @ V)

    @precise
    def mean_and_var(self, x):
        # fused diagonal variant: the cross-gram K(X, x*) goes through the
        # gram kernel, its whitening through the held L⁻¹ (``covmat.Whitener``)
        with span("posterior.mean_and_var"):
            with span("model.cross_gram"):
                K_Xx = self.prior.cov(self.data.x, x)
            m = self.prior.mean(x) + K_Xx.T @ self.data.alpha
            v = self.prior.var(x) - covmat.diag_At_A(self._whiten(K_Xx))
            return m, torch.clamp(v, min=0.0)


@precise
def posterior(fx: FiniteGP, y) -> PosteriorGP:
    """Exact conditioning ``posterior(fx, y)``; a projection of a
    PosteriorGP extends the cached Cholesky (sequential conditioning,
    identical to batch conditioning on the concatenated data)."""
    y = as_tensor(y)
    if isinstance(fx.f, PosteriorGP):
        return _sequential_posterior(fx, y)
    m, L = fx._chol()
    delta = y - m
    alpha = covmat.chol_solve(L, delta)
    return PosteriorGP(fx.f, _ExactCache(alpha, L, fx.x, delta, fx.noise))


@precise
def _sequential_posterior(fx: FiniteGP, y: torch.Tensor) -> PosteriorGP:
    post: PosteriorGP = fx.f
    prior = post.prior
    x_new = fx.x
    delta2 = y - prior.mean(x_new)
    C12 = prior.cov(post.data.x, x_new)
    C22 = fx.noise.add_to(prior.cov(x_new))
    L = covmat.update_chol(post.data.L, C12, C22)
    delta = torch.cat([post.data.delta, delta2])
    alpha = covmat.chol_solve(L, delta)
    x = torch.cat([post.data.x, x_new], dim=0)
    noise = (None if post.data.noise is None
             else noise_block_diag(post.data.noise, fx.noise))
    return PosteriorGP(prior, _ExactCache(alpha, L, x, delta, noise))


@dataclasses.dataclass(frozen=True)
class ExactInference:
    """Marker making exact regression a degenerate 'approximation':
    ``posterior(ExactInference(), fx, y)`` = ``posterior(fx, y)`` and its
    ``approx_log_evidence`` = ``logpdf``."""

    def posterior(self, fx: FiniteGP, y) -> PosteriorGP:
        return posterior(fx, y)

    def approx_log_evidence(self, fx: FiniteGP, y) -> torch.Tensor:
        return fx.logpdf(y)


def approx_log_evidence_exact(fx: FiniteGP, y) -> torch.Tensor:
    return fx.logpdf(y)
