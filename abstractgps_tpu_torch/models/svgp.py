"""Stochastic variational GP — minibatched inducing-point ELBO (SVGP).

Counterpart of the JAX package's ``models/svgp.py``. The reference's VFE
bound is *collapsed* (optimal q(u) eliminated analytically), so every ELBO
evaluation touches all N points. This module adds the uncollapsed bound
(Hensman et al. 2013) with an explicit whitened variational distribution

    ε = L_zz⁻¹ u,   q(ε) = N(m, C Cᵀ)          (C lower-triangular)

whose ELBO decomposes over data points, so a minibatch gives an unbiased
estimator at O(B·M² + M³) per step regardless of N. On the card (f32) the
cross-gram ``K(z, x_batch)`` and ``K(z, z)`` run the fused gram kernel, and
their backward the gram VJP kernel in all three modes; ``chol(Kzz)`` runs
the blocked factorization from M = 1024 on.

Link back to the reference: for a Gaussian likelihood the optimal (m, C)
are closed-form (``optimal_variational_params``), and plugging them into
``svgp_elbo`` on the full batch recovers the collapsed VFE bound
``elbo(VFE(fz), fx, y)``; predictions from ``SVGPPosterior`` with those
parameters match ``posterior(VFE(fz), fx, y)``. Non-Gaussian likelihoods
use Gauss–Hermite quadrature over the per-point marginals
(``svgp_elbo_quadrature``).

``SVGP`` is an ``nn.Module`` whose tensors are attributes kept as given, so
an SVGP rebuilt from a constrained parameter tree each step stays in the
caller's autograd graph. The training loops run ``torch.optim.Adam`` (the
update and defaults of ``optax.adam``) and write the per-step ELBO trace on
the device. Their minibatch indices come from a draws object
(``MinibatchDraws`` over a ``torch.Generator`` by default), so another
stream of indices can be replayed.
"""

from __future__ import annotations

import copy
import math
import numbers

import numpy as np
import torch
from torch import nn

from ..kernels.base import Kernel, hyperparameters
from ..means import as_mean, mean_vector
from ..ops import covmat
from ..ops.distance import as_inputs, as_tensor
from ..ops.noise import DenseNoise, DiagonalNoise, IsotropicNoise, as_noise
from ..ops.precision import precise
from ..params import inv_softplus, softplus
from ..utils.profiling import span
from .gp import AbstractGP

__all__ = [
    "SVGP",
    "SVGPPosterior",
    "MinibatchDraws",
    "svgp_init",
    "svgp_elbo",
    "svgp_elbo_quadrature",
    "svgp_posterior",
    "optimal_variational_params",
    "set_variational",
    "gauss_hermite_expectation",
    "fit_svgp",
    "natgrad_step",
    "fit_svgp_natgrad",
]

DEFAULT_INDUCING_JITTER = 1e-6


def _tril_from_raw(C_raw: torch.Tensor) -> torch.Tensor:
    """Lower-triangular with softplus-positive diagonal (so a Cholesky-like
    C is unconstrained-optimizable; the bijector of ``params.positive``)."""
    return torch.tril(C_raw, -1) + torch.diag(softplus(torch.diagonal(C_raw)))


def _raw_from_tril(C: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_tril_from_raw`` for a C with strictly positive diag."""
    return torch.tril(C, -1) + torch.diag(inv_softplus(torch.diagonal(C)))


class SVGP(nn.Module):
    """Whitened stochastic variational GP state.

    Fields: prior mean function + kernel (submodules), inducing locations
    ``z`` (M, D), whitened variational mean ``m`` (M,) and raw lower factor
    ``C_raw`` (M, M); ``jitter`` stabilises chol(Kzz). The tensors are kept
    as given (a caller's tensor that requires grad stays in its graph);
    ``replace`` returns a copy with some fields changed.
    """

    def __init__(self, mean_fn, kernel: Kernel, z, m, C_raw, jitter):
        super().__init__()
        self.mean_fn = as_mean(mean_fn)
        self.kernel = kernel
        self.z = as_inputs(z)
        self.m = as_tensor(m)
        self.C_raw = as_tensor(C_raw)
        self.jitter = as_tensor(jitter)

    def replace(self, **changes) -> "SVGP":
        fields = dict(mean_fn=self.mean_fn, kernel=self.kernel, z=self.z, m=self.m,
                      C_raw=self.C_raw, jitter=self.jitter)
        fields.update(changes)
        return SVGP(**fields)

    @property
    def num_inducing(self) -> int:
        return self.z.shape[0]

    @property
    def C(self) -> torch.Tensor:
        return _tril_from_raw(self.C_raw)

    # -- whitened projection pieces ----------------------------------------

    def _Lz(self):
        Kzz = covmat.add_jitter(self.kernel.gram(self.z), self.jitter)
        return covmat.cholesky_lower(Kzz)

    def _A(self, Lz, x):
        """``A = L_zz⁻¹ K(z, x)`` — (M, B) whitened cross-gram."""
        with span("model.cross_gram"):
            Kzx = self.kernel.cross(self.z, x)
        return covmat.solve_lower(Lz, Kzx)

    @precise
    def predict(self, x, full_cov: bool = False):
        """Marginal posterior q(f(x)) = N(μ, Σ) under the current q(ε)."""
        x = as_inputs(x)
        Lz = self._Lz()
        A = self._A(Lz, x)
        mu = mean_vector(self.mean_fn, x) + A.T @ self.m
        CtA = self.C.T @ A
        if full_cov:
            K = self.kernel.gram(x)
            cov = K - A.T @ A + CtA.T @ CtA
            return mu, covmat.symmetrize(cov)
        kdiag = self.kernel.diag(x)
        var = kdiag - torch.sum(A * A, dim=0) + torch.sum(CtA * CtA, dim=0)
        return mu, torch.clamp(var, min=0.0)

    @precise
    def kl(self) -> torch.Tensor:
        """KL(q(ε) ‖ N(0, I)) — the whitened prior, so no Kzz solves."""
        C = self.C
        M = self.m.shape[0]
        logdet_S = 2.0 * torch.sum(torch.log(torch.diagonal(C)))
        tr_S = torch.sum(C * C)
        return 0.5 * (tr_S + torch.dot(self.m, self.m) - M - logdet_S)


def svgp_init(kernel: Kernel, z, mean_fn=None, jitter=DEFAULT_INDUCING_JITTER) -> SVGP:
    """Fresh SVGP with q(ε) = N(0, I) (i.e. q(f) = prior at the start)."""
    z = as_inputs(z)
    M = z.shape[0]
    dt = z.dtype if z.is_floating_point() else torch.float64
    eye = torch.eye(M, dtype=dt, device=z.device)
    return SVGP(mean_fn, kernel, z, torch.zeros((M,), dtype=dt, device=z.device),
                _raw_from_tril(eye), torch.as_tensor(jitter, dtype=dt, device=z.device))


def set_variational(svgp: SVGP, m: torch.Tensor, C: torch.Tensor) -> SVGP:
    """A copy with whitened variational params (m, C); C must be
    lower-triangular with positive diagonal."""
    return svgp.replace(m=m, C_raw=_raw_from_tril(C))


# ---------------------------------------------------------------------------
# ELBOs
# ---------------------------------------------------------------------------


def _scale(n_total, B: int) -> float:
    return 1.0 if n_total is None else n_total / B


@precise
def svgp_elbo(svgp: SVGP, x, y, noise, n_total: int | None = None):
    """Uncollapsed ELBO, Gaussian likelihood, closed-form expectations.

    ``noise`` is scalar/vector/Noise as in FiniteGP. With ``n_total`` given
    and ``len(x) == B < n_total``, the data term is scaled by ``n_total/B``
    — the unbiased minibatch estimator (the batch must be uniformly drawn).
    """
    with span("model.svgp_elbo"):
        x = as_inputs(x)
        B = x.shape[0]
        sig2 = as_noise(noise, B, like=x).diag()
        mu, var_f = svgp.predict(x)
        resid = as_tensor(y) - mu
        # E_q log N(y | f, σ²) = log N(y | μ, σ²) − var_f / (2σ²)
        ell = (-0.5 * (torch.log(2.0 * math.pi * sig2) + resid * resid / sig2)
               - var_f / (2.0 * sig2))
        return _scale(n_total, B) * torch.sum(ell) - svgp.kl()


def gauss_hermite_expectation(log_lik, mu, var, y, num_points: int = 20):
    """``E_{f ~ N(mu, var)}[log_lik(f, y)]`` per point by Gauss–Hermite.

    ``log_lik(f, y)`` must broadcast elementwise. The nodes and weights are
    numpy's ``hermgauss``, so the expectation is one (Q, B) elementwise
    block and a weighted sum.
    """
    t, w = np.polynomial.hermite.hermgauss(num_points)
    t = torch.as_tensor(t, dtype=mu.dtype, device=mu.device)  # (Q,)
    w = torch.as_tensor(w / math.sqrt(math.pi), dtype=mu.dtype, device=mu.device)
    f = mu[None, :] + torch.sqrt(2.0 * torch.clamp(var, min=0.0))[None, :] * t[:, None]
    vals = log_lik(f, as_tensor(y)[None, :])
    return w @ vals  # (B,)


@precise
def svgp_elbo_quadrature(svgp: SVGP, x, y, log_lik, n_total: int | None = None,
                         num_points: int = 20):
    """Uncollapsed ELBO for a non-Gaussian likelihood ``log_lik(f, y)``
    (e.g. Poisson: ``y * f - exp(f) - lgamma(y + 1)``), expectations by
    Gauss–Hermite quadrature."""
    x = as_inputs(x)
    B = x.shape[0]
    mu, var_f = svgp.predict(x)
    ell = gauss_hermite_expectation(log_lik, mu, var_f, y, num_points)
    return _scale(n_total, B) * torch.sum(ell) - svgp.kl()


# ---------------------------------------------------------------------------
# Posterior-as-GP wrapper + the collapsed-bound oracle
# ---------------------------------------------------------------------------


class SVGPPosterior(AbstractGP):
    """The variational posterior process as an AbstractGP, so the standard
    projection machinery (FiniteGP, rand, logpdf) composes with it."""

    def __init__(self, svgp: SVGP):
        self.svgp = svgp

    def mean(self, x):
        mu, _ = self.svgp.predict(x)
        return mu

    @precise
    def cov(self, x, z=None):
        if z is None:
            _, S = self.svgp.predict(x, full_cov=True)
            return S
        sv = self.svgp
        x, z = as_inputs(x), as_inputs(z)
        Lz = sv._Lz()
        Ax, Az = sv._A(Lz, x), sv._A(Lz, z)
        C = sv.C
        CtAx, CtAz = C.T @ Ax, C.T @ Az
        return sv.kernel.cross(x, z) - Ax.T @ Az + CtAx.T @ CtAz

    def var(self, x):
        _, v = self.svgp.predict(x)
        return v

    def mean_and_var(self, x):
        # one predict call = one chol(Kzz) + one cross-gram solve
        return self.svgp.predict(x)

    def mean_and_cov(self, x):
        return self.svgp.predict(x, full_cov=True)


def svgp_posterior(svgp: SVGP) -> SVGPPosterior:
    return SVGPPosterior(svgp)


def _eye(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(m, dtype=like.dtype, device=like.device)


@precise
def optimal_variational_params(svgp: SVGP, x, y, noise):
    """Closed-form optimal whitened (m, C) for a Gaussian likelihood.

    With ``Ā = A · diag(1/σ)`` and ``ỹ = (y − prior_mean)/σ``:
    ``S* = (I + Ā Āᵀ)⁻¹``, ``m* = S* Ā ỹ``. Substituting collapses the
    bound onto the reference's VFE elbo (Λ_ε = chol(ĀĀᵀ + I) is the same
    matrix).
    """
    x = as_inputs(x)
    n = x.shape[0]
    sig = torch.sqrt(as_noise(noise, n, like=x).diag())
    Lz = svgp._Lz()
    A = svgp._A(Lz, x) / sig[None, :]
    yt = (as_tensor(y) - mean_vector(svgp.mean_fn, x)) / sig
    M = A.shape[0]
    eye = _eye(M, A)
    Lam = covmat.cholesky_lower(A @ A.T + eye)
    # S* = Λ⁻ᵀ Λ⁻¹  ⇒  C* = L(S*) ; m* = S* A ỹ
    inv_Lam = covmat.solve_lower(Lam, eye)
    S = inv_Lam.T @ inv_Lam
    m = S @ (A @ yt)
    C = covmat.cholesky_lower(covmat.symmetrize(S))
    return m, C


# ---------------------------------------------------------------------------
# Natural gradients on the variational distribution
# ---------------------------------------------------------------------------


def _elbo_mS(svgp: SVGP, m, S, x, y, noise, n_total, log_lik, num_points):
    """The ELBO as an explicit function of the whitened moments (m, S) —
    the parameterization the natural-gradient step differentiates. Mirrors
    ``svgp_elbo``/``svgp_elbo_quadrature`` exactly (S enters only through
    ``diag(Aᵀ S A)``, ``tr S`` and ``logdet S``)."""
    x = as_inputs(x)
    y = as_tensor(y)
    B = x.shape[0]
    Lz = svgp._Lz()
    A = svgp._A(Lz, x)
    mu = mean_vector(svgp.mean_fn, x) + A.T @ m
    var_f = torch.clamp(
        svgp.kernel.diag(x) - torch.sum(A * A, dim=0) + torch.sum(A * (S @ A), dim=0),
        min=0.0)
    if log_lik is None:
        sig2 = as_noise(noise, B, like=x).diag()
        ell = (-0.5 * (torch.log(2.0 * math.pi * sig2) + (y - mu) ** 2 / sig2)
               - var_f / (2.0 * sig2))
    else:
        ell = gauss_hermite_expectation(log_lik, mu, var_f, y, num_points)
    Mi = m.shape[0]
    L_S = covmat.cholesky_lower(covmat.symmetrize(S))
    kl = 0.5 * (torch.trace(S) + torch.dot(m, m) - Mi
                - 2.0 * torch.sum(torch.log(torch.diagonal(L_S))))
    return _scale(n_total, B) * torch.sum(ell) - kl


@precise
def natgrad_step(svgp: SVGP, x, y, noise=None, *, lr: float = 0.1,
                 n_total: int | None = None, log_lik=None, num_points: int = 20) -> SVGP:
    """One natural-gradient ascent step on the variational distribution.

    Natural gradients follow the ELBO's gradient in the natural parameters
    ``θ₁ = S⁻¹m, θ₂ = −½S⁻¹``, which equals the ordinary gradient taken with
    respect to the expectation parameters ``ξ₁ = m, ξ₂ = S + mmᵀ``:

        dL/dξ₁ = dL/dm − 2 (dL/dS) m,   dL/dξ₂ = dL/dS
        θ ← θ + lr · dL/dξ ;  recover  S = −½ θ₂⁻¹,  m = S θ₁

    For a Gaussian likelihood on the full batch the ELBO is quadratic in ξ,
    so ``lr=1`` jumps to the exact optimum in one step. The gradient is
    ``torch.autograd.grad`` with respect to (m, S) only. A failed Cholesky
    surfaces as NaN.
    """
    m0 = svgp.m.detach()
    C0 = svgp.C.detach()
    S0 = covmat.symmetrize(C0 @ C0.T)

    m_var = m0.clone().requires_grad_()
    S_var = S0.clone().requires_grad_()
    with torch.enable_grad():
        val = _elbo_mS(svgp, m_var, S_var, x, y, noise, n_total, log_lik, num_points)
        gm, gS = torch.autograd.grad(val, (m_var, S_var))
    gS = covmat.symmetrize(gS)

    dxi1 = gm - 2.0 * gS @ m0
    dxi2 = gS

    eye = _eye(m0.shape[0], m0)
    theta1 = covmat.chol_solve(C0, m0)          # S⁻¹ m
    theta2 = -0.5 * covmat.chol_solve(C0, eye)

    theta1 = theta1 + lr * dxi1
    theta2 = theta2 + lr * dxi2

    # recover the moments; P = −2θ₂ must stay SPD (guaranteed at small lr,
    # and exactly for lr <= 1 with a Gaussian likelihood)
    P = covmat.symmetrize(-2.0 * theta2)
    L_P = covmat.cholesky_lower(P)
    S_new = covmat.chol_solve(L_P, eye)
    m_new = covmat.chol_solve(L_P, theta1)
    C_new = covmat.cholesky_lower(covmat.symmetrize(S_new))
    return set_variational(svgp, m_new, C_new)


# ---------------------------------------------------------------------------
# Minibatch training loops
# ---------------------------------------------------------------------------


class MinibatchDraws:
    """The minibatch indices of ``fit_svgp``/``fit_svgp_natgrad``: each step
    ``batch_size`` indices uniform on [0, n), with replacement, from one
    ``torch.Generator`` on the data's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def indices(self, n: int, batch_size: int, device) -> torch.Tensor:
        return torch.randint(0, n, (batch_size,), generator=self.generator, device=device)


def _as_minibatch_draws(source, device):
    """A draws object as it is, or ``MinibatchDraws`` over a generator or
    over a new generator on ``device`` seeded with the given int."""
    if isinstance(source, numbers.Integral):
        source = torch.Generator(device=device).manual_seed(int(source))
    if isinstance(source, torch.Generator):
        return MinibatchDraws(source)
    return source


def _fresh_module(module: nn.Module) -> nn.Module:
    """A deep copy whose hyperparameter tensors are new leaves that require
    grad (``nn.Parameter``s stay parameters)."""
    memo = {}
    for t in hyperparameters(module):
        new = t.detach().clone()
        memo[id(t)] = nn.Parameter(new) if isinstance(t, nn.Parameter) else new.requires_grad_()
    return copy.deepcopy(module, memo)


def _leaf(t: torch.Tensor, trainable: bool) -> torch.Tensor:
    t = t.detach().clone()
    return t.requires_grad_() if trainable else t


class _Minibatches:
    """The data of a training loop and its per-step minibatches; a per-point
    (heteroscedastic) noise vector is sliced with the batch."""

    def __init__(self, generator, x, y, noise, batch_size: int):
        self.x = as_inputs(x)
        self.y = as_tensor(y)
        self.n = self.x.shape[0]
        self.batch_size = batch_size
        self.draws = _as_minibatch_draws(generator, self.x.device)
        self.noise = noise
        self.noise_vec = (noise is not None and np.ndim(noise) == 1 and not isinstance(
            noise, (IsotropicNoise, DiagonalNoise, DenseNoise)))
        if self.noise_vec:
            self.noise = as_tensor(noise, device=self.x.device)

    def next(self):
        idx = self.draws.indices(self.n, self.batch_size, self.x.device)
        idx = torch.as_tensor(idx, device=self.x.device)
        nb = self.noise[idx] if self.noise_vec else self.noise
        return self.x[idx], self.y[idx], nb


def _trace(steps: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((steps,), float("nan"), dtype=like.dtype, device=like.device)


def _neg_elbo(sv, xb, yb, nb, n, log_lik, num_points):
    if log_lik is None:
        return -svgp_elbo(sv, xb, yb, nb, n_total=n)
    return -svgp_elbo_quadrature(sv, xb, yb, log_lik, n_total=n, num_points=num_points)


def fit_svgp_natgrad(generator, svgp: SVGP, x, y, noise=None, *, batch_size: int,
                     steps: int, natgrad_lr: float = 0.1, hyper_lr: float = 1e-2,
                     log_lik=None, num_points: int = 20, train_inducing: bool = True):
    """Alternating trainer: a natural-gradient step on (m, C), then an Adam
    step on the inducing locations — the standard fast SVGP recipe.
    ``generator`` is a ``torch.Generator``, an int seed or a draws object
    with ``indices(n, batch_size, device)``. Returns
    ``(fitted_svgp, elbo_trace)``; ``elbo_trace[i]`` is the minibatch ELBO
    after step i's natural-gradient step, written on the device.

    Kernel/mean hyperparameters are frozen; optimise a constrained parameter
    tree that rebuilds the SVGP for joint MLE.
    """
    data = _Minibatches(generator, x, y, noise, batch_size)
    z = _leaf(svgp.z, train_inducing)
    sv = svgp.replace(z=z, m=svgp.m.detach(), C_raw=svgp.C_raw.detach())
    opt = torch.optim.Adam([z], lr=hyper_lr) if train_inducing else None
    trace = _trace(steps, sv.m)
    for i in range(steps):
        xb, yb, nb = data.next()
        sv = natgrad_step(sv, xb, yb, nb, lr=natgrad_lr, n_total=data.n,
                          log_lik=log_lik, num_points=num_points)
        with torch.enable_grad():
            loss = _neg_elbo(sv, xb, yb, nb, data.n, log_lik, num_points)
            if opt is not None:
                (z.grad,) = torch.autograd.grad(loss, [z])
        if opt is not None:
            opt.step()
        trace[i] = -loss.detach()
    return sv.replace(z=z.detach()), trace


def fit_svgp(generator, svgp: SVGP, x, y, noise, *, batch_size: int, steps: int,
             learning_rate: float = 1e-2, log_lik=None, num_points: int = 20,
             train_inducing: bool = True, train_hyper: bool = False):
    """Adam (``torch.optim.Adam``) on the negative stochastic ELBO.

    Trains the variational parameters (m, C) and, with ``train_inducing``,
    the inducing locations; minibatches are drawn uniformly with replacement
    from ``generator`` (a ``torch.Generator``, an int seed or a draws
    object). ``noise`` is held fixed; a per-point noise vector is sliced
    with the batch. Kernel/mean hyperparameters are frozen unless
    ``train_hyper`` (then a copy of the kernel and mean is trained: use it
    only with a sign-safe parameterization); for joint MLE-II + VI,
    optimise a tagged parameter tree that rebuilds the SVGP. The jitter is
    a stabiliser, never trained. For non-Gaussian observations pass
    ``log_lik(f, y)`` (quadrature path). Returns
    ``(fitted_svgp, elbo_trace)`` with the per-step minibatch ELBO, written
    on the device.
    """
    data = _Minibatches(generator, x, y, noise, batch_size)
    kernel, mean_fn = svgp.kernel, svgp.mean_fn
    if train_hyper:
        kernel, mean_fn = _fresh_module(kernel), _fresh_module(mean_fn)
    sv = svgp.replace(kernel=kernel, mean_fn=mean_fn, z=_leaf(svgp.z, train_inducing),
                      m=_leaf(svgp.m, True), C_raw=_leaf(svgp.C_raw, True))
    params = [sv.m, sv.C_raw] + ([sv.z] if train_inducing else [])
    if train_hyper:
        params += hyperparameters(kernel) + hyperparameters(mean_fn)
    opt = torch.optim.Adam(params, lr=learning_rate)
    trace = _trace(steps, sv.m)
    for i in range(steps):
        xb, yb, nb = data.next()
        with torch.enable_grad():
            loss = _neg_elbo(sv, xb, yb, nb, data.n, log_lik, num_points)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        trace[i] = -loss.detach()
    return sv.replace(z=sv.z.detach(), m=sv.m.detach(), C_raw=sv.C_raw.detach()), trace
