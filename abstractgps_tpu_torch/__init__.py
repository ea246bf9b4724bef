"""abstractgps_tpu_torch — the PyTorch/CUDA port of abstractgps_tpu.

Exact GP regression on an NVIDIA H100 (reference surface: AbstractGPs.jl):
GP priors, FiniteGP projections, the log marginal likelihood, and exact
posteriors with sequential conditioning. Kernels and means are
``nn.Module``s; models and ops are plain functions on tensors. At size on
the card (f32) the hot path runs hand-written CUDA kernels (``csrc/``):
the fused gram tile, the slab and block Cholesky factor+inverse, and the
batched triangular inverse behind the wide prediction solves.

Tensors keep their device; other inputs go to the default device
(``"cuda"``; ``set_default_device("cpu")`` for CPU use). The JAX package
``abstractgps_tpu`` is the frozen reference this port is tested against.
"""

from . import kernels, ops  # noqa: F401
from .convert import kernel_from_numpy, mean_from_numpy, noise_from_numpy
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
    y)`` dispatches on the approximation (``ExactInference()``)."""
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


def std(fx: FiniteGP):
    """Marginal standard deviations of a projection."""
    import torch

    return torch.sqrt(fx.var())
