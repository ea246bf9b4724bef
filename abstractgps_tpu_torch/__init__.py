"""abstractgps_tpu_torch — the PyTorch/CUDA port of abstractgps_tpu.

GP regression on an NVIDIA H100 (reference surface: AbstractGPs.jl): GP
priors, FiniteGP projections, the log marginal likelihood, and exact
posteriors with sequential conditioning, their gradients, and MLE-II
fitting over tagged parameter trees (``params``, ``fit``, ``fit_lbfgs``);
the sparse VFE/DTC approximations with online updates and their ELBO
(``neg_elbo``); the stochastic variational GP (``SVGP``, minibatch Adam
and natural-gradient training); streaming exact conditioning into a
fixed-capacity cache (``models.online``); the matrix-free CG backend
(``CGInference``, ``cg_logpdf``: batched CG, SLQ logdets, the BBMM
gradient) and pathwise posterior sampling with random Fourier features
(``pathwise_sample``); the Markov (state-space) backend for Matérn kernels
on 1-D inputs (``markov_logpdf``, ``markov_posterior``: sequential and
parallel-in-time Kalman filters, the RTS smoother, FFBS sampling); LatentGPs under the likelihoods of
``distributions``, and the NUTS, HMC, elliptical-slice and SMC samplers of
``inference.mcmc``. Kernels, means and the SVGP state are
``nn.Module``s; the other models and the ops are plain classes and
functions on tensors. At size on the card (f32) the hot path runs
hand-written CUDA kernels (``csrc/``): the fused gram tile, the slab and
block Cholesky factor+inverse, the batched triangular inverse behind the
wide solves and the logpdf backward, the gram VJP and the logpdf-backward
contraction. ``utils.test_utils`` holds the interface conformance suites.

Tensors keep their device; other inputs go to the default device
(``"cuda"``; ``set_default_device("cpu")`` for CPU use). The JAX package
``abstractgps_tpu`` is the frozen reference this port is tested against.
"""

from . import distributions, inference, kernels, ops, params, utils  # noqa: F401
from .convert import (
    cg_posterior_from_numpy,
    fourier_features_from_numpy,
    kernel_from_numpy,
    mean_from_numpy,
    noise_from_numpy,
    online_from_numpy,
    params_from_numpy,
    svgp_from_numpy,
)
from .inference import FitResult, fit, fit_lbfgs, neg_elbo, nlml
from .kernels import *  # noqa: F401,F403 — kernel zoo re-export
from .kernels.base import (
    ARDTransform,
    FunctionTransform,
    LinearTransform,
    ScaleTransform,
    compose,
    kernelmatrix,
    kernelmatrix_diag,
    with_lengthscale,
)
from .means import ConstMean, CustomMean, ZeroMean, as_mean, mean_vector
from .models import exact_posterior as _exact
from .models.exact_posterior import ExactInference, PosteriorGP
from .models.finite_gp import (
    FiniteGP,
    gradlogpdf,
    loglikelihood,
    logpdf,
    marginals,
    rand,
    sqmahal,
)
from .models.gp import AbstractGP, GP, cov, mean, mean_and_cov, mean_and_var, var
from .models.iterative import CGInference, CGPosteriorGP, cg_logpdf, mbcg, slq_logdet
from .models.latent_gp import LatentFiniteGP, LatentGP
from .models.markov import (
    MarkovPosteriorGP,
    is_markov_kernel,
    markov_logpdf,
    markov_mean_and_var,
    markov_posterior,
    markov_rand,
)
from .models.pathwise import (
    FourierFeatures,
    pathwise_sample,
    prior_function_sample,
    sample_fourier_features,
)
from .models.sparse import (
    DTC,
    VFE,
    ApproxPosteriorGP,
    elbo,
    inducing_points,
    update_posterior,
)
from .models.svgp import (
    SVGP,
    SVGPPosterior,
    fit_svgp,
    fit_svgp_natgrad,
    natgrad_step,
    svgp_elbo,
    svgp_elbo_quadrature,
    svgp_init,
    svgp_posterior,
)
from .ops.distance import (
    as_inputs,
    col_vecs,
    get_default_device,
    row_vecs,
    set_default_device,
)
from .ops.noise import (
    DEFAULT_NOISE_VARIANCE,
    DenseNoise,
    DiagonalNoise,
    IsotropicNoise,
    as_noise,
    noise_block_diag,
)
from .ops.precision import get_matmul_precision, set_matmul_precision

__version__ = "0.1.0"


def posterior(*args):
    """``posterior(fx, y)`` → exact PosteriorGP; ``posterior(approx, fx,
    y)`` dispatches on the approximation (``ExactInference()``, ``VFE``,
    ``DTC``, ``CGInference()``)."""
    if len(args) == 2:
        fx, y = args
        return _exact.posterior(fx, y)
    if len(args) == 3:
        approx, fx, y = args
        return approx.posterior(fx, y)
    raise TypeError(f"posterior takes 2 or 3 arguments, got {len(args)}")


def approx_log_evidence(approx, fx, y):
    """Approximate log marginal likelihood under ``approx``."""
    return approx.approx_log_evidence(fx, y)


def dtc(d: DTC, fx, y):
    """Deprecated alias for ``approx_log_evidence(DTC(...), fx, y)``
    (src/deprecations.jl:9)."""
    import warnings

    warnings.warn("dtc is deprecated; use approx_log_evidence", DeprecationWarning)
    return d.approx_log_evidence(fx, y)


def std(fx: FiniteGP):
    """Marginal standard deviations of a projection."""
    import torch

    return torch.sqrt(fx.var())
