"""AbstractGP interface + the concrete GP prior.

Reference: src/abstract_gp.jl (interface) and src/base_gp.jl (GP prior).
Every GP type implements ``mean(x)``, ``cov(x)``, ``cov(x, z)``, ``var(x)``,
with ``mean_and_cov`` / ``mean_and_var`` defaulting to the pair; ``var``
never goes through ``diag(cov)``. Projection ``f(x, σ²)`` returns a
FiniteGP; posteriors are themselves AbstractGPs.
"""

from __future__ import annotations

import torch

from ..kernels.base import Kernel
from ..means import as_mean, mean_vector
from ..ops.distance import as_inputs
from ..ops.precision import precise

__all__ = ["AbstractGP", "GP", "mean", "cov", "var", "mean_and_cov", "mean_and_var"]


class AbstractGP:
    """Base for all GP types."""

    def mean(self, x) -> torch.Tensor:
        raise NotImplementedError

    def cov(self, x, z=None) -> torch.Tensor:
        raise NotImplementedError

    def var(self, x) -> torch.Tensor:
        raise NotImplementedError

    def mean_and_cov(self, x):
        return self.mean(x), self.cov(x)

    def mean_and_var(self, x):
        return self.mean(x), self.var(x)

    def __call__(self, x, noise=None, obsdim: int | None = None):
        """Project onto finite inputs: ``f(x, σ²)`` → FiniteGP."""
        from .finite_gp import FiniteGP

        return FiniteGP.create(self, as_inputs(x, obsdim=obsdim), noise)


class GP(AbstractGP):
    """GP prior = mean function + kernel: ``GP(kernel)`` (zero mean),
    ``GP(c, kernel)`` (constant mean), ``GP(fn, kernel)`` (custom mean)."""

    def __init__(self, mean_fn=None, kernel: Kernel | None = None):
        if kernel is None:
            if not isinstance(mean_fn, Kernel):
                raise TypeError("GP(kernel) requires a Kernel")
            mean_fn, kernel = None, mean_fn
        self.mean_fn = as_mean(mean_fn)
        self.kernel = kernel

    def to(self, *args, **kwargs) -> "GP":
        """Move the mean function's and kernel's parameters (in place)."""
        self.mean_fn.to(*args, **kwargs)
        self.kernel.to(*args, **kwargs)
        return self

    @precise
    def mean(self, x):
        return mean_vector(self.mean_fn, x)

    @precise
    def cov(self, x, z=None):
        if z is None:
            return self.kernel.gram(as_inputs(x))
        return self.kernel.cross(as_inputs(x), as_inputs(z))

    @precise
    def var(self, x):
        return self.kernel.diag(as_inputs(x))


# ---------------------------------------------------------------------------
# Reference-named free functions over (f, x) pairs
# ---------------------------------------------------------------------------


def mean(f: AbstractGP, x) -> torch.Tensor:
    return f.mean(x)


def cov(f: AbstractGP, x, z=None) -> torch.Tensor:
    return f.cov(x, z)


def var(f: AbstractGP, x) -> torch.Tensor:
    return f.var(x)


def mean_and_cov(f: AbstractGP, x):
    return f.mean_and_cov(x)


def mean_and_var(f: AbstractGP, x):
    return f.mean_and_var(x)
