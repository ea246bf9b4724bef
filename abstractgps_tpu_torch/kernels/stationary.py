"""Concrete kernels: stationary (isotropic) + dot-product + periodic families.

Isotropic kernels share one path: a squared-distance gram followed by an
elementwise map ``_apply_sqdist``. At size on the card (f32, ≥ 512² pairs)
``cross``/``gram`` go to the hand-written ``gram_tile`` kernel of
``ops.fused_gram``, which fuses the distance and the map; each isotropic
class names its epilogue there by ``FAMILY`` and hands its
hyperparameters over with ``_map_params``. The other kernels are plain
torch.
"""

from __future__ import annotations

import math

import torch

from ..means import as_param
from ..ops import fused_gram
from ..ops.distance import as_inputs, safe_sqrt
from .base import Kernel

__all__ = [
    "IsotropicKernel",
    "SqExponentialKernel",
    "SEKernel",
    "RBFKernel",
    "GaussianKernel",
    "ExponentialKernel",
    "Matern12Kernel",
    "LaplacianKernel",
    "Matern32Kernel",
    "Matern52Kernel",
    "MaternKernel",
    "RationalQuadraticKernel",
    "GammaExponentialKernel",
    "CosineKernel",
    "PeriodicKernel",
    "WhiteKernel",
    "ConstantKernel",
    "ZeroKernel",
    "LinearKernel",
    "PolynomialKernel",
    "ExponentiatedKernel",
]


def _float_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.is_floating_point() else torch.float64


class IsotropicKernel(Kernel):
    """Kernel of the form k(x, z) = g(‖x − z‖²)."""

    FAMILY: int  # epilogue id of the gram_tile kernel (fused_gram.FAMILIES)

    def _apply_sqdist(self, d2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _map_params(self) -> tuple:
        """Hyperparameters of the map g, in the kernel's order."""
        return ()

    def cross(self, x, z):
        x, z = as_inputs(x), as_inputs(z)
        if fused_gram.should_use_kernel(x, z):
            return fused_gram.fused_isotropic_gram(self, x, z)
        return fused_gram.plain_isotropic_gram(self, x, z)

    def gram(self, x):
        x = as_inputs(x)
        if fused_gram.should_use_kernel(x, x):
            return fused_gram.fused_isotropic_gram(self, x, x, symmetric=True)
        return fused_gram.plain_isotropic_gram(self, x, x, symmetric=True)

    def diag(self, x):
        x = as_inputs(x)
        return self._apply_sqdist(
            torch.zeros((x.shape[0],), dtype=_float_dtype(x), device=x.device))


class SqExponentialKernel(IsotropicKernel):
    """Squared-exponential (RBF): ``exp(−d²/2)``."""

    FAMILY = 0

    def _apply_sqdist(self, d2):
        return torch.exp(-0.5 * d2)


SEKernel = SqExponentialKernel
RBFKernel = SqExponentialKernel
GaussianKernel = SqExponentialKernel


class ExponentialKernel(IsotropicKernel):
    """Exponential / Matern-1/2: ``exp(−d)``."""

    FAMILY = 1

    def _apply_sqdist(self, d2):
        return torch.exp(-safe_sqrt(d2))


Matern12Kernel = ExponentialKernel
LaplacianKernel = ExponentialKernel


class Matern32Kernel(IsotropicKernel):
    """Matern-3/2: ``(1 + √3 d)·exp(−√3 d)``."""

    FAMILY = 2

    def _apply_sqdist(self, d2):
        t = math.sqrt(3.0) * safe_sqrt(d2)
        return (1.0 + t) * torch.exp(-t)


class Matern52Kernel(IsotropicKernel):
    """Matern-5/2: ``(1 + √5 d + 5d²/3)·exp(−√5 d)``."""

    FAMILY = 3

    def _apply_sqdist(self, d2):
        t = math.sqrt(5.0) * safe_sqrt(d2)
        return (1.0 + t + t * t / 3.0) * torch.exp(-t)


def MaternKernel(nu: float = 1.5) -> IsotropicKernel:
    """Matern kernel for half-integer ν ∈ {0.5, 1.5, 2.5}."""
    if nu == 0.5:
        return ExponentialKernel()
    if nu == 1.5:
        return Matern32Kernel()
    if nu == 2.5:
        return Matern52Kernel()
    raise NotImplementedError(
        f"MaternKernel only supports nu in (0.5, 1.5, 2.5); got {nu}"
    )


class RationalQuadraticKernel(IsotropicKernel):
    """Rational quadratic: ``(1 + d²/(2α))^(−α)``."""

    FAMILY = 4

    def __init__(self, alpha=2.0):
        super().__init__()
        self.alpha = as_param(alpha)

    def _map_params(self):
        return (self.alpha,)

    def _apply_sqdist(self, d2):
        a = self.alpha.to(d2.dtype)
        return torch.pow(1.0 + d2 / (2.0 * a), -a)


class GammaExponentialKernel(IsotropicKernel):
    """γ-exponential: ``exp(−d^γ)`` for γ ∈ (0, 2]."""

    FAMILY = 5

    def __init__(self, gamma=1.0):
        super().__init__()
        self.gamma = as_param(gamma)

    def _map_params(self):
        return (self.gamma,)

    def _apply_sqdist(self, d2):
        # d^γ = (d²)^(γ/2); guard the 0^γ gradient like safe_sqrt.
        pos = d2 > 0.0
        safe = torch.where(pos, d2, torch.ones_like(d2))
        p = torch.where(pos, torch.pow(safe, 0.5 * self.gamma.to(d2.dtype)),
                        torch.zeros_like(d2))
        return torch.exp(-p)


class CosineKernel(IsotropicKernel):
    """Cosine kernel: ``cos(π d)``."""

    FAMILY = 6

    def _apply_sqdist(self, d2):
        return torch.cos(math.pi * safe_sqrt(d2))


class WhiteKernel(Kernel):
    """White noise kernel: 1 where inputs coincide (exact elementwise
    equality, as in KernelFunctions' δ), else 0."""

    def cross(self, x, z):
        x, z = as_inputs(x), as_inputs(z)
        eq = torch.all(x[:, None, :] == z[None, :, :], dim=-1)
        return eq.to(_float_dtype(x))

    def gram(self, x):
        # equality semantics, consistent with cross(x, x) on duplicate rows
        return self.cross(x, x)

    def diag(self, x):
        x = as_inputs(x)
        return torch.ones((x.shape[0],), dtype=_float_dtype(x), device=x.device)


class ConstantKernel(Kernel):
    """Constant kernel: k(x, z) = c."""

    def __init__(self, c=1.0):
        super().__init__()
        self.c = as_param(c)

    def cross(self, x, z):
        x, z = as_inputs(x), as_inputs(z)
        c = self.c.to(device=x.device, dtype=_float_dtype(x))
        return c.expand(x.shape[0], z.shape[0])

    def diag(self, x):
        x = as_inputs(x)
        c = self.c.to(device=x.device, dtype=_float_dtype(x))
        return c.expand(x.shape[0])


class ZeroKernel(Kernel):
    """Identically-zero kernel."""

    def cross(self, x, z):
        x, z = as_inputs(x), as_inputs(z)
        return torch.zeros((x.shape[0], z.shape[0]), dtype=_float_dtype(x),
                           device=x.device)

    def diag(self, x):
        x = as_inputs(x)
        return torch.zeros((x.shape[0],), dtype=_float_dtype(x), device=x.device)


class PeriodicKernel(Kernel):
    """Periodic kernel (KernelFunctions parameterisation):

    ``k(x, z) = exp(−0.5 Σ_d sin²(π (x_d − z_d)) / r_d²)``

    with per-dimension r (``period`` names KernelFunctions' ``r``). Not
    isotropic: per-dimension differences as an (N, M, D) broadcast.
    """

    def __init__(self, period=1.0):
        super().__init__()
        p = as_param(period)
        if p.ndim == 0:
            p = (torch.nn.Parameter(p.detach().reshape(1))
                 if isinstance(p, torch.nn.Parameter) else p.reshape(1))
        self.period = p

    def cross(self, x, z):
        x, z = as_inputs(x), as_inputs(z)
        diff = x[:, None, :] - z[None, :, :]
        s = torch.sin(math.pi * diff) / self.period.to(device=x.device,
                                                       dtype=x.dtype)
        return torch.exp(-0.5 * torch.sum(s * s, dim=-1))

    def diag(self, x):
        x = as_inputs(x)
        return torch.ones((x.shape[0],), dtype=_float_dtype(x), device=x.device)


class LinearKernel(Kernel):
    """Linear kernel: ``k(x, z) = x·z + c``."""

    def __init__(self, c=0.0):
        super().__init__()
        self.c = as_param(c)

    def cross(self, x, z):
        x, z = as_inputs(x), as_inputs(z)
        return x @ z.T + self.c

    def diag(self, x):
        x = as_inputs(x)
        return torch.sum(x * x, dim=-1) + self.c


class PolynomialKernel(Kernel):
    """Polynomial kernel: ``k(x, z) = (x·z + c)^degree``."""

    def __init__(self, degree: int = 2, c=0.0):
        super().__init__()
        self.degree = degree
        self.c = as_param(c)

    def cross(self, x, z):
        x, z = as_inputs(x), as_inputs(z)
        return torch.pow(x @ z.T + self.c, self.degree)

    def diag(self, x):
        x = as_inputs(x)
        return torch.pow(torch.sum(x * x, dim=-1) + self.c, self.degree)


class ExponentiatedKernel(Kernel):
    """Exponentiated dot-product kernel: ``k(x, z) = exp(x·z)``."""

    def cross(self, x, z):
        x, z = as_inputs(x), as_inputs(z)
        return torch.exp(x @ z.T)

    def diag(self, x):
        x = as_inputs(x)
        return torch.exp(torch.sum(x * x, dim=-1))
