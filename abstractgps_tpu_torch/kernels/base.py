"""Kernel layer — base interface, algebra, and input transforms.

Kernels are ``nn.Module``s whose hyperparameters are ``nn.Parameter``s, so
autograd flows through them and ``kernel.to(device)`` moves them. Every
kernel implements three tensor-level ops (whole gram tiles, never scalar
pair loops):

- ``cross(x, z) -> (N, M)``   cross-covariance matrix
- ``gram(x) -> (N, N)``       symmetric gram matrix
- ``diag(x) -> (N,)``         gram diagonal, never forming the off-diagonal

matching ``kernelmatrix(k, x, z)``, ``kernelmatrix(k, x)`` and
``kernelmatrix_diag(k, x)`` in the reference surface. Calling a kernel,
``k(x, z)``, evaluates it on two single inputs.
"""

from __future__ import annotations

import torch
from torch import nn

from ..means import as_param
from ..ops.distance import as_inputs, as_tensor
from ..ops.precision import precise

__all__ = [
    "Kernel",
    "KernelSum",
    "KernelProduct",
    "ScaledKernel",
    "TransformedKernel",
    "ScaleTransform",
    "ARDTransform",
    "LinearTransform",
    "FunctionTransform",
    "with_lengthscale",
    "compose",
    "kernelmatrix",
    "kernelmatrix_diag",
]


class Kernel(nn.Module):
    """Base class for all kernels. Subclasses implement ``cross``/``diag``."""

    def cross(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def gram(self, x: torch.Tensor) -> torch.Tensor:
        x = as_inputs(x)
        return self.cross(x, x)

    def diag(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x, z) -> torch.Tensor:
        """Scalar kernel evaluation k(x, z) for single inputs."""
        xa = torch.atleast_1d(as_tensor(x))
        za = torch.atleast_1d(as_tensor(z))
        return self.cross(xa[None, :], za[None, :])[0, 0]

    # -- algebra (KernelFunctions `+`, `*`, scalar scaling) ----------------

    def __add__(self, other):
        if isinstance(other, Kernel):
            parts = []
            for k in (self, other):
                parts.extend(k.kernels if isinstance(k, KernelSum) else (k,))
            return KernelSum(parts)
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, Kernel):
            parts = []
            for k in (self, other):
                parts.extend(k.kernels if isinstance(k, KernelProduct) else (k,))
            return KernelProduct(parts)
        return ScaledKernel(self, other)

    def __rmul__(self, other):
        return self.__mul__(other)


class KernelSum(Kernel):
    """Sum of kernels: ``(k₁ + k₂)(x, z) = k₁(x, z) + k₂(x, z)``."""

    def __init__(self, kernels):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)

    def cross(self, x, z):
        mats = [k.cross(x, z) for k in self.kernels]
        return sum(mats[1:], start=mats[0])

    def gram(self, x):
        mats = [k.gram(x) for k in self.kernels]
        return sum(mats[1:], start=mats[0])

    def diag(self, x):
        vecs = [k.diag(x) for k in self.kernels]
        return sum(vecs[1:], start=vecs[0])


class KernelProduct(Kernel):
    """Product of kernels: ``(k₁ k₂)(x, z) = k₁(x, z) · k₂(x, z)``."""

    def __init__(self, kernels):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)

    def cross(self, x, z):
        out = self.kernels[0].cross(x, z)
        for k in self.kernels[1:]:
            out = out * k.cross(x, z)
        return out

    def gram(self, x):
        out = self.kernels[0].gram(x)
        for k in self.kernels[1:]:
            out = out * k.gram(x)
        return out

    def diag(self, x):
        out = self.kernels[0].diag(x)
        for k in self.kernels[1:]:
            out = out * k.diag(x)
        return out


class ScaledKernel(Kernel):
    """``σ² · k`` — premultiplied variance (KernelFunctions ScaledKernel)."""

    def __init__(self, kernel: Kernel, variance):
        super().__init__()
        self.kernel = kernel
        self.variance = as_param(variance)

    def cross(self, x, z):
        return self.variance * self.kernel.cross(x, z)

    def gram(self, x):
        return self.variance * self.kernel.gram(x)

    def diag(self, x):
        return self.variance * self.kernel.diag(x)


# ---------------------------------------------------------------------------
# Input transforms (KernelFunctions ∘ Transform)
# ---------------------------------------------------------------------------


class ScaleTransform(nn.Module):
    """x → s·x. ``k ∘ ScaleTransform(1/ℓ)`` is a lengthscale-ℓ kernel."""

    def __init__(self, s):
        super().__init__()
        self.s = as_param(s)

    def forward(self, x):
        return self.s * x


class ARDTransform(nn.Module):
    """x → v ⊙ x with per-dimension scales v (ARD lengthscales)."""

    def __init__(self, v):
        super().__init__()
        self.v = as_param(v)

    def forward(self, x):
        return x * self.v.to(x.dtype)[None, :]


class LinearTransform(nn.Module):
    """x → A·x (rows transformed by A: (N, D) → (N, D'))."""

    def __init__(self, A):
        super().__init__()
        self.A = as_param(A)

    def forward(self, x):
        return x @ self.A.to(x.dtype).T


class FunctionTransform(nn.Module):
    """x → fn(params, x) for an arbitrary batched feature map (the
    deep-kernel-learning path). ``params`` is an ``nn.Module`` (registered,
    so its parameters train with the kernel), a tensor, or None."""

    def __init__(self, params, fn):
        super().__init__()
        self.params = params
        self.fn = fn

    def forward(self, x):
        return self.fn(self.params, x)


class TransformedKernel(Kernel):
    """``k ∘ t``: evaluate k on transformed inputs."""

    def __init__(self, kernel: Kernel, transform):
        super().__init__()
        self.kernel = kernel
        self.transform = transform

    def _t(self, x):
        return self.transform(as_inputs(x))

    def cross(self, x, z):
        return self.kernel.cross(self._t(x), self._t(z))

    def gram(self, x):
        return self.kernel.gram(self._t(x))

    def diag(self, x):
        return self.kernel.diag(self._t(x))


def compose(kernel: Kernel, transform) -> TransformedKernel:
    """``k ∘ t`` (Julia's ``∘`` composition)."""
    return TransformedKernel(kernel, transform)


def with_lengthscale(kernel: Kernel, lengthscale) -> TransformedKernel:
    """Kernel with lengthscale ℓ: inputs scaled by 1/ℓ. Scalar ℓ →
    isotropic; vector ℓ → ARD."""
    ell = as_param(lengthscale).detach()
    if ell.ndim == 0:
        return TransformedKernel(kernel, ScaleTransform(1.0 / ell))
    return TransformedKernel(kernel, ARDTransform(1.0 / ell))


# ---------------------------------------------------------------------------
# Reference-named free functions
# ---------------------------------------------------------------------------


@precise
def kernelmatrix(k: Kernel, x, z=None) -> torch.Tensor:
    """``kernelmatrix(k, x[, z])`` — gram or cross-gram matrix."""
    x = as_inputs(x)
    if z is None:
        return k.gram(x)
    return k.cross(x, as_inputs(z))


@precise
def kernelmatrix_diag(k: Kernel, x) -> torch.Tensor:
    """``kernelmatrix_diag(k, x)`` — diagonal of the gram matrix."""
    return k.diag(as_inputs(x))
