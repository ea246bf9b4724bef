"""Pathwise (decoupled) posterior sampling via random Fourier features.

Counterpart of the JAX package's ``models/pathwise.py`` (Wilson et al.
2020, arXiv:2002.09309): a posterior function sample is a prior function
sample plus a data-dependent update,

    f_post(·) = f_prior(·) + K(·, X) (K + Σ)⁻¹ (y − f_prior(X) − ε),
    ε ~ N(0, Σ),

where ``f_prior`` is a prior path built from m random Fourier features
(Rahimi & Recht 2007). After the exact posterior's one O(N³) factor, each
sample is a function evaluable anywhere at O(m + N) a point. The feature
map is one (nx, m) GEMM and a cosine; s paths are one (m, s) GEMM.

Spectral samplers for the unit-lengthscale forms of ``kernels/stationary.py``
(lengthscales and ARD enter through the peeled input transforms,
amplitudes through ``ScaledKernel``):

- SqExponential: ω ~ N(0, I)
- Matern-ν (ν = 1/2, 3/2, 5/2): ω = z·sqrt(2ν / w), z ~ N(0, I), w ~ χ²_{2ν}
- RationalQuadratic(α): τ ~ Gamma(α, rate α), ω ~ N(0, τ I)
- KernelSum: one block of features per addend
- KernelProduct of stationary factors: spectra convolve, ω = Σ_j ω_j

Randomness: a ``torch.Generator``, an int seed or a draws object
(``ops.draws``), drawn in the JAX package's order. The returned closures
run their GEMMs under the library's precision policy (``precise``), since
they are called after the constructor's own scope has ended.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.base import (
    ARDTransform,
    Kernel,
    KernelProduct,
    KernelSum,
    LinearTransform,
    ScaledKernel,
    ScaleTransform,
    TransformedKernel,
)
from ..kernels.stationary import (
    ExponentialKernel,
    Matern32Kernel,
    Matern52Kernel,
    RationalQuadraticKernel,
    SqExponentialKernel,
)
from ..ops import covmat
from ..ops.distance import as_inputs, resolve_device
from ..ops.draws import as_draws
from ..ops.noise import DenseNoise
from ..ops.precision import precise
from .exact_posterior import PosteriorGP
from .gp import GP

__all__ = [
    "FourierFeatures",
    "sample_fourier_features",
    "prior_function_sample",
    "pathwise_sample",
]


# ---------------------------------------------------------------------------
# Spectral samplers: ω-draws for the unit-lengthscale stationary families.
# ---------------------------------------------------------------------------


def _spectral_sample(kernel: Kernel, draws, m: int, d: int, dtype, device):
    """Draw m frequency vectors ω ∈ R^d (raw-input space) from the kernel's
    spectral density. Returns ``(omega, variance)``, ``variance`` the
    amplitude gathered from ScaledKernel wrappers.

    Linear input transforms (Scale/ARD/Linear) are folded into the
    frequencies, ωᵀ(Ax) = (Aᵀω)ᵀx, so products of per-factor-lengthscaled
    kernels work; a nonlinear transform inside a product cannot be folded
    and raises.
    """
    if isinstance(kernel, ScaledKernel):
        omega, v = _spectral_sample(kernel.kernel, draws, m, d, dtype, device)
        return omega, v * kernel.variance
    if isinstance(kernel, TransformedKernel):
        t = kernel.transform
        if isinstance(t, ScaleTransform):
            omega, v = _spectral_sample(kernel.kernel, draws, m, d, dtype, device)
            return t.s * omega, v
        if isinstance(t, ARDTransform):
            omega, v = _spectral_sample(kernel.kernel, draws, m, d, dtype, device)
            return omega * t.v[None, :], v
        if isinstance(t, LinearTransform):
            omega, v = _spectral_sample(kernel.kernel, draws, m, t.A.shape[0], dtype, device)
            return omega @ t.A, v
        raise NotImplementedError(
            "cannot fold a nonlinear input transform into frequency space "
            "inside a kernel product; apply FunctionTransforms at the "
            "outermost level instead"
        )
    if isinstance(kernel, SqExponentialKernel):
        return draws.normal((m, d), dtype, device), 1.0
    if isinstance(kernel, ExponentialKernel):
        return _matern_omega(draws, m, d, 0.5, dtype, device), 1.0
    if isinstance(kernel, Matern32Kernel):
        return _matern_omega(draws, m, d, 1.5, dtype, device), 1.0
    if isinstance(kernel, Matern52Kernel):
        return _matern_omega(draws, m, d, 2.5, dtype, device), 1.0
    if isinstance(kernel, RationalQuadraticKernel):
        tau = draws.gamma(kernel.alpha, (m, 1), dtype, device) / kernel.alpha
        return draws.normal((m, d), dtype, device) * torch.sqrt(tau), 1.0
    if isinstance(kernel, KernelProduct):
        # stationary product ⇒ spectral densities convolve ⇒ ω = Σ_j ω_j
        omega = torch.zeros((m, d), dtype=dtype, device=device)
        var = 1.0
        for k in kernel.kernels:
            o, v = _spectral_sample(k, draws, m, d, dtype, device)
            omega, var = omega + o, var * v
        return omega, var
    raise NotImplementedError(
        f"no spectral sampler for {type(kernel).__name__}; pathwise sampling "
        "supports SE/Matern/RationalQuadratic kernels and their "
        "scale/lengthscale/sum/product algebra"
    )


def _matern_omega(draws, m: int, d: int, nu: float, dtype, device) -> torch.Tensor:
    """ω ~ multivariate-t with 2ν dof: z·sqrt(2ν/w), w ~ χ²_{2ν}."""
    z = draws.normal((m, d), dtype, device)
    w = 2.0 * draws.gamma(nu, (m, 1), dtype, device)  # χ²_{2ν} = Gamma(ν, scale 2)
    return z * torch.sqrt(2.0 * nu / w)


# ---------------------------------------------------------------------------
# Feature map
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class FourierFeatures:
    """φ(x) = weights ⊙ cos(t(x)·ωᵀ + b) with E[φ(x)ᵀφ(z)] ≈ k(x, z).

    ``transforms`` is the peeled input-transform chain (outermost first),
    applied before the frequency GEMM.
    """

    omega: torch.Tensor    # (m, D') frequencies
    bias: torch.Tensor     # (m,) phases ~ U(0, 2π)
    weights: torch.Tensor  # (m,) per-feature amplitudes √(2σ²/m_block)
    transforms: tuple      # input transforms, applied in order

    @property
    def num_features(self) -> int:
        return self.omega.shape[0]

    @precise
    def __call__(self, x) -> torch.Tensor:
        x = as_inputs(x)
        for t in self.transforms:
            x = t(x)
        proj = x @ self.omega.T + self.bias[None, :]
        return torch.cos(proj) * self.weights[None, :]  # (N, m)


def _peel(kernel: Kernel):
    """Split k = σ² · (base ∘ t₁ ∘ t₂ …) into (base, transforms, variance)."""
    variance = 1.0
    transforms = []
    while True:
        if isinstance(kernel, ScaledKernel):
            variance = variance * kernel.variance
            kernel = kernel.kernel
        elif isinstance(kernel, TransformedKernel):
            transforms.append(kernel.transform)
            kernel = kernel.kernel
        else:
            return kernel, tuple(transforms), variance


def _out_dim(transforms, d: int, dtype, device) -> int:
    """Input dimension after the transform chain (a probe row through it)."""
    for t in transforms:
        d = t(torch.zeros((1, d), dtype=dtype, device=device)).shape[-1]
    return d


def sample_fourier_features(kernel: Kernel, draws, num_features: int, input_dim: int,
                            *, dtype=torch.float32, device=None):
    """Draw an m-feature random Fourier expansion of ``kernel``.

    ``input_dim`` is the raw input dimension D (1 for scalar inputs). Sums
    get ``num_features`` features per addend, so the estimator stays
    unbiased for composite kernels. ``draws`` is a generator, a seed or a
    draws object; the features are made in ``dtype`` on ``device`` (the
    package's default device when None).
    """
    device = resolve_device(device)
    draws = as_draws(draws, device)
    base, transforms, variance = _peel(kernel)

    if isinstance(base, KernelSum):
        # one feature block per addend (each may carry its own transforms)
        sub_dim = _out_dim(transforms, input_dim, dtype, device)
        blocks = []
        for k in base.kernels:
            ff = sample_fourier_features(k, draws, num_features, sub_dim,
                                         dtype=dtype, device=device)
            blocks.append(_scale_weights(ff, _sqrt(variance)))
        if any(isinstance(b, _ConcatFeatures) or b.transforms for b in blocks):
            # heterogeneous per-addend transforms: keep the blocks apart
            return _ConcatFeatures(tuple(blocks), tuple(transforms))
        return FourierFeatures(
            torch.cat([b.omega for b in blocks]),
            torch.cat([b.bias for b in blocks]),
            torch.cat([b.weights for b in blocks]),
            tuple(transforms),
        )

    d_eff = _out_dim(transforms, input_dim, dtype, device)
    omega, v_inner = _spectral_sample(base, draws, num_features, d_eff, dtype, device)
    bias = draws.uniform((num_features,), 2.0 * math.pi, dtype, device)
    w = torch.full((num_features,), math.sqrt(2.0 / num_features), dtype=dtype, device=device)
    return FourierFeatures(omega, bias, _sqrt(variance * v_inner) * w, tuple(transforms))


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def _scale_weights(ff, s):
    if isinstance(ff, _ConcatFeatures):
        return _ConcatFeatures(tuple(_scale_weights(b, s) for b in ff.blocks), ff.transforms)
    return dataclasses.replace(ff, weights=s * ff.weights)


@dataclasses.dataclass(frozen=True, eq=False)
class _ConcatFeatures:
    """Concatenation of per-addend feature maps with an outer transform
    chain (sum kernels whose addends carry their own transforms)."""

    blocks: tuple
    transforms: tuple

    @property
    def num_features(self) -> int:
        return sum(b.num_features for b in self.blocks)

    @precise
    def __call__(self, x) -> torch.Tensor:
        x = as_inputs(x)
        for t in self.transforms:
            x = t(x)
        return torch.cat([b(x) for b in self.blocks], dim=-1)


# ---------------------------------------------------------------------------
# Prior and posterior path samplers
# ---------------------------------------------------------------------------


def prior_function_sample(f: GP, draws, num_features: int, input_dim: int,
                          num_samples: int | None = None, *, dtype=torch.float32,
                          device=None):
    """Approximate prior path(s): h(x) = m(x) + φ(x)·w, w ~ N(0, I_m).

    Returns a callable ``h`` with ``h(x) -> (nx,)`` (or ``(nx, s)`` when
    ``num_samples`` is given). The features and weights are drawn (in that
    order) in ``dtype`` on ``device`` (the default device when None).
    """
    device = resolve_device(device)
    draws = as_draws(draws, device)
    phi = sample_fourier_features(f.kernel, draws, num_features, input_dim,
                                  dtype=dtype, device=device)
    s = 1 if num_samples is None else num_samples
    w = draws.normal((phi.num_features, s), dtype, device)

    @precise
    def h(x):
        x = as_inputs(x)
        out = phi(x) @ w + f.mean(x)[:, None]
        return out[:, 0] if num_samples is None else out

    return h


@precise
def pathwise_sample(post: PosteriorGP, draws, num_features: int = 1024,
                    num_samples: int | None = None):
    """Posterior function sample(s) from an exact ``PosteriorGP``.

    Returns a callable ``g`` with ``g(x) -> (nx,)`` (or ``(nx, s)``):

        g(·) = m(·) + φ(·)w + K(·, X)·v,
        v = (K + Σ)⁻¹ (δ − φ(X)w − ε),   ε ~ N(0, Σ),

    through the posterior's cached Cholesky (a wide right-hand side takes
    the trtri solve). Matches ``post(x).rand`` in distribution up to the
    O(1/√m) truncation of the prior term. Draws, in order: the features,
    the weights w (m, s), the noise's normals (N, s); all in the training
    inputs' dtype on their device.
    """
    cache = post.data
    x_train, L, delta = cache.x, cache.L, cache.delta
    prior = post.prior
    dtype, device = x_train.dtype, x_train.device
    draws = as_draws(draws, device)
    d = as_inputs(x_train).shape[-1]
    s = 1 if num_samples is None else num_samples

    phi = sample_fourier_features(prior.kernel, draws, num_features, d,
                                  dtype=dtype, device=device)
    w = draws.normal((phi.num_features, s), dtype, device)

    # ε ~ N(0, Σy), from the projection noise recorded on the cache
    if cache.noise is None:
        raise NotImplementedError(
            "pathwise_sample needs the posterior's observation-noise record; "
            "this cache has none (e.g. a sequentially-extended posterior "
            "with correlated DenseNoise)."
        )
    z_eps = draws.normal((delta.shape[0], s), dtype, device)
    if isinstance(cache.noise, DenseNoise):
        eps = cache.noise._chol() @ z_eps
    else:
        eps = torch.sqrt(cache.noise.diag())[:, None] * z_eps

    resid = delta[:, None] - phi(x_train) @ w - eps  # (N, s)
    v = covmat.chol_solve(L, resid)                   # (N, s)

    @precise
    def g(xs):
        xs_in = as_inputs(xs)
        cross = prior.kernel.cross(xs_in, x_train)  # (nx, N)
        out = prior.mean(xs_in)[:, None] + phi(xs_in) @ w + cross @ v
        return out[:, 0] if num_samples is None else out

    return g
