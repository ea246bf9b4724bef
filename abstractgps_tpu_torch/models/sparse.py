"""Sparse approximations: Titsias VFE and Seeger DTC.

Counterpart of the JAX package's ``models/sparse.py`` (reference:
src/sparse_approximations.jl:1-313). The whitened cache
``(m_ε, Λ_ε, U, α, b_y, B_εf, x, Σy)`` is kept with lower Cholesky factors
(``U ↦ L_z``, ``Λ_ε.U ↦ L_Λ``); every solve below is the lower-triangular
counterpart of the reference's upper-triangular op (``U' \\ X ↦ L⁻¹X``,
``U \\ X ↦ L⁻ᵀX``).

Online updates are supported for both new observations (rank-k update of
Λ_ε) and new pseudo-points (two block Cholesky extensions).

One deliberate divergence from the reference, as in the JAX package: when
appending pseudo-points the reference forms ``C22 = cov(prior, z)``
*without* the inducing jitter, which breaks the update≡batch invariant for
non-negligible jitter; ``fz.noise`` is included here so the invariant holds
exactly.

At size on the card (f32) the cross-covariances ``K(x, z)`` and ``K(z, z)``
run the fused gram kernel and its VJP (``ops.fused_gram``); the Cholesky of
``Kzz`` runs the blocked factorization from M = 1024 on.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import covmat
from ..ops.distance import as_tensor
from ..ops.noise import Noise, noise_block_diag
from ..ops.precision import precise
from ..parallel.collectives import data_psum
from .finite_gp import _LOG_2PI, FiniteGP
from .gp import AbstractGP

__all__ = [
    "VFE",
    "DTC",
    "ApproxPosteriorGP",
    "posterior_vfe",
    "update_posterior",
    "elbo",
    "approx_log_evidence",
    "inducing_points",
]


@dataclasses.dataclass(frozen=True)
class VFE:
    """Variational Free Energy approximation (Titsias 2009). ``fz`` is the
    inducing-point projection ``f(z, jitter)``."""

    fz: FiniteGP

    def posterior(self, fx: FiniteGP, y) -> "ApproxPosteriorGP":
        return posterior_vfe(self, fx, y)

    def approx_log_evidence(self, fx: FiniteGP, y) -> torch.Tensor:
        return elbo(self, fx, y)


@dataclasses.dataclass(frozen=True)
class DTC:
    """Deterministic Training Conditional (Seeger 2003). Same posterior as
    VFE, different ``approx_log_evidence``."""

    fz: FiniteGP

    def posterior(self, fx: FiniteGP, y) -> "ApproxPosteriorGP":
        return posterior_vfe(self, fx, y)

    def approx_log_evidence(self, fx: FiniteGP, y) -> torch.Tensor:
        dtc_objective, _ = _collapsed_terms(fx, as_tensor(y), self.fz, trace=False)
        return dtc_objective


@dataclasses.dataclass(frozen=True)
class _SparseCache:
    m_eps: torch.Tensor     # (m,)   whitened posterior mean
    L_Lambda: torch.Tensor  # (m, m) chol(B B' + I), lower
    L_z: torch.Tensor       # (m, m) chol(Kzz + jitter), lower
    alpha: torch.Tensor     # (m,)   L_z⁻ᵀ m_ε
    b_y: torch.Tensor       # (N,)   noise-whitened residual
    B_ef: torch.Tensor      # (m, N) whitened cross-covariance
    x: torch.Tensor         # (N, D) training inputs
    Sigma_y: Noise


class ApproxPosteriorGP(AbstractGP):
    """Approximate posterior process."""

    def __init__(self, approx, prior: AbstractGP, data: _SparseCache):
        self.approx = approx
        self.prior = prior
        self.data = data

    def _A(self, x):
        """``A = L_z⁻¹ K(z, x*)`` — the shared whitened cross-gram."""
        return covmat.solve_lower(self.data.L_z,
                                  self.prior.cov(inducing_points(self), x))

    @precise
    def mean(self, x):
        return (self.prior.mean(x)
                + self.prior.cov(x, inducing_points(self)) @ self.data.alpha)

    @precise
    def cov(self, x, z=None):
        if z is None:
            A = self._A(x)
            return (self.prior.cov(x) - covmat.At_A(A)
                    + covmat.Xt_invA_X(self.data.L_Lambda, A))
        A_zx = self._A(x)
        A_zy = self._A(z)
        return (self.prior.cov(x, z) - A_zx.T @ A_zy
                + covmat.Xt_invA_Y(A_zx, self.data.L_Lambda, A_zy))

    @precise
    def var(self, x):
        A = self._A(x)
        v = (self.prior.var(x) - covmat.diag_At_A(A)
             + covmat.diag_Xt_invA_X(self.data.L_Lambda, A))
        # clamped at 0 against f32 cancellation
        return torch.clamp(v, min=0.0)

    @precise
    def mean_and_cov(self, x):
        A = self._A(x)
        m = self.prior.mean(x) + A.T @ self.data.m_eps
        C = (self.prior.cov(x) - covmat.At_A(A)
             + covmat.Xt_invA_X(self.data.L_Lambda, A))
        return m, C

    @precise
    def mean_and_var(self, x):
        A = self._A(x)
        m = self.prior.mean(x) + A.T @ self.data.m_eps
        v = (self.prior.var(x) - covmat.diag_At_A(A)
             + covmat.diag_Xt_invA_X(self.data.L_Lambda, A))
        return m, torch.clamp(v, min=0.0)


def inducing_points(f: ApproxPosteriorGP) -> torch.Tensor:
    """The inducing inputs z of an approximate posterior."""
    return f.approx.fz.x


def _eye(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(m, dtype=like.dtype, device=like.device)


@precise
def posterior_vfe(approx, fx: FiniteGP, y) -> ApproxPosteriorGP:
    """Optimal approximate posterior (src/sparse_approximations.jl:58-75)."""
    y = as_tensor(y)
    fz = approx.fz
    L_z = covmat.cholesky_lower(fz.cov())           # chol(Kzz + jitter)
    Kxz = fx.cov(fz)                                # (N, m)
    B_ef = covmat.solve_lower(L_z, fx.noise.solve_sqrt(Kxz).T)  # (m, N)
    b_y = fx.noise.solve_sqrt(y - fx.mean())        # (N,)
    m = B_ef.shape[0]
    L_Lambda = covmat.cholesky_lower(B_ef @ B_ef.T + _eye(m, B_ef))
    m_eps = covmat.chol_solve(L_Lambda, B_ef @ b_y)
    alpha = covmat.solve_upper(L_z, m_eps)
    cache = _SparseCache(m_eps, L_Lambda, L_z, alpha, b_y, B_ef, fx.x, fx.noise)
    return ApproxPosteriorGP(approx, fx.f, cache)


@precise
def update_posterior(f_post: ApproxPosteriorGP, fx_or_fz: FiniteGP, y=None) -> ApproxPosteriorGP:
    """Online update of a sparse posterior.

    - ``update_posterior(post, fx, y)``: append new observations, keeping
      the pseudo-points (src/sparse_approximations.jl:87-119).
    - ``update_posterior(post, fz)``: append new pseudo-points
      (src/sparse_approximations.jl:130-176).
    """
    if y is None:
        return _update_posterior_pseudopoints(f_post, fx_or_fz)
    return _update_posterior_observations(f_post, fx_or_fz, as_tensor(y))


def _update_posterior_observations(f_post: ApproxPosteriorGP, fx: FiniteGP,
                                   y: torch.Tensor) -> ApproxPosteriorGP:
    data = f_post.data
    z = inducing_points(f_post)

    Sigma_y = noise_block_diag(data.Sigma_y, fx.noise)
    b_y = torch.cat([data.b_y, fx.noise.solve_sqrt(y - fx.mean())])

    Kxz_new = f_post.prior.cov(fx.x, z)             # (N2, m)
    B2 = covmat.solve_lower(data.L_z, fx.noise.solve_sqrt(Kxz_new).T)  # (m, N2)
    B_ef = torch.cat([data.B_ef, B2], dim=1)

    # rank-N2 update of Λ_ε (the reference loops lowrankupdate! per column)
    L_Lambda = covmat.lowrank_update_chol(data.L_Lambda, B2)

    m_eps = covmat.chol_solve(L_Lambda, B_ef @ b_y)
    alpha = covmat.solve_upper(data.L_z, m_eps)
    x = torch.cat([data.x, fx.x], dim=0)

    cache = _SparseCache(m_eps, L_Lambda, data.L_z, alpha, b_y, B_ef, x, Sigma_y)
    return ApproxPosteriorGP(f_post.approx, f_post.prior, cache)


def _update_posterior_pseudopoints(f_post: ApproxPosteriorGP,
                                   fz: FiniteGP) -> ApproxPosteriorGP:
    data = f_post.data
    prior = f_post.prior
    z_old = inducing_points(f_post)
    z = fz.x
    m2 = z.shape[0]

    C12 = prior.cov(z_old, z)
    C22 = fz.noise.add_to(prior.cov(z))  # the reference omits the jitter here
    L_z = covmat.update_chol(data.L_z, C12, C22)
    L21 = L_z[-m2:, :-m2]   # = U12'
    L22 = L_z[-m2:, -m2:]   # = U22'

    B1 = data.B_ef
    Cu2f = prior.cov(z, data.x)          # (m2, N)
    # Cu2f · U_y⁻¹ = (L_y⁻¹ Cu2f')'
    Cu2f_w = data.Sigma_y.solve_sqrt(Cu2f.T).T
    B2 = covmat.solve_lower(L22, Cu2f_w - L21 @ B1)  # (m2, N)
    B_ef = torch.cat([B1, B2], dim=0)

    L_Lambda = covmat.update_chol(data.L_Lambda, B1 @ B2.T, B2 @ B2.T + _eye(m2, B2))

    m_eps = covmat.chol_solve(L_Lambda, B_ef @ data.b_y)
    alpha = covmat.solve_upper(L_z, m_eps)

    z_new = torch.cat([z_old, z], dim=0)
    fz_new = FiniteGP.create(f_post.approx.fz.f, z_new,
                             noise_block_diag(f_post.approx.fz.noise, fz.noise))
    approx_new = type(f_post.approx)(fz_new)

    cache = _SparseCache(m_eps, L_Lambda, L_z, alpha, data.b_y, B_ef, data.x, data.Sigma_y)
    return ApproxPosteriorGP(approx_new, prior, cache)


# ---------------------------------------------------------------------------
# Objectives (src/sparse_approximations.jl:248-313)
# ---------------------------------------------------------------------------


@precise
def _collapsed_terms(fx: FiniteGP, y: torch.Tensor, fz: FiniteGP, trace: bool):
    """The collapsed bound's terms (src/sparse_approximations.jl:289-305):
    the DTC objective, and with ``trace`` the ELBO's trace term
    ``tr(Cf Σy⁻¹) − ‖A‖²_F``.

    Every term that sums over the data (A·Aᵀ, A·δ, ‖δ‖², log|Σy|, n·log 2π and the
    trace term's two sums) goes through one ``data_psum``: while a data axis
    is active (``parallel.fit_sharded``) and ``fx.x`` or ``y`` is a shard of
    it, it is summed over the ranks' shards in one packed all-reduce, and
    L_Λ is formed from the global sums on every rank; data that is no shard
    raises there; with no active axis it is the identity."""
    Kxz = fx.cov(fz)                                 # (N, m)
    L_z = covmat.cholesky_lower(fz.cov())
    A = covmat.solve_lower(L_z, fx.noise.solve_sqrt(Kxz).T)   # (m, N)
    delta = fx.noise.solve_sqrt(y - fx.mean())
    n_log_2pi = torch.tensor(y.shape[0] * _LOG_2PI, dtype=A.dtype, device=A.device)
    terms = [A @ A.T, A @ delta, torch.sum(delta * delta), fx.noise.logdet(), n_log_2pi]
    if trace:
        terms += [fx.noise.tr_solve(fx.f.var(fx.x)), torch.sum(A * A)]
    AAt, Ad, dd, logdet_noise, n_log_2pi, *tr = data_psum((fx.x, y), *terms)
    m = A.shape[0]
    L_Lambda = covmat.cholesky_lower(AAt + _eye(m, A))
    tmp = (logdet_noise
           + covmat.logdet_from_chol(L_Lambda)
           + dd
           - torch.sum(torch.square(covmat.solve_lower(L_Lambda, Ad))))
    dtc_objective = -0.5 * (n_log_2pi + tmp)
    return dtc_objective, (tr[0] - tr[1] if trace else None)


def approx_log_evidence(approx, fx: FiniteGP, y) -> torch.Tensor:
    """Dispatch on approximation type (VFE ELBO / DTC objective /
    ExactInference → logpdf)."""
    return approx.approx_log_evidence(fx, y)


@precise
def elbo(vfe: VFE, fx: FiniteGP, y) -> torch.Tensor:
    """Titsias ELBO (src/sparse_approximations.jl:248-254):
    ``dtc_objective − (tr(Cf Σy⁻¹) − ‖A‖²_F) / 2``."""
    dtc_objective, trace_term = _collapsed_terms(fx, as_tensor(y), vfe.fz, trace=True)
    return dtc_objective - 0.5 * trace_term
