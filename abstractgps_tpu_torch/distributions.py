"""Minimal batched distribution layer for non-Gaussian likelihoods.

Counterpart of the JAX package's ``distributions.py``. A distribution is a
small frozen dataclass of tensors with a vectorised ``logpdf(y)`` (the
per-element log density) and ``sample(generator)``, which draws from a
``torch.Generator`` on the parameters' device. Products over independent
elements are sums of the per-element logpdfs (``product_distribution``).

The log densities are written out rather than taken from
``torch.distributions``: they are the JAX package's formulas (its Poisson
logpdf, for one, is defined at non-integer ``y``), so the two packages give
the same numbers.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "Normal",
    "MvNormal",
    "Poisson",
    "Bernoulli",
    "Exponential",
    "Gamma",
    "LogNormal",
    "ProductDistribution",
    "product_distribution",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _broadcast(generator, *params):
    """The parameters as tensors of one broadcast shape, on their device (a
    tensor's, else the generator's) in their floating dtype (a tensor's,
    else float64 for Python numbers, as the JAX package's x64 mode)."""
    ts = [p for p in params if isinstance(p, torch.Tensor)]
    dtype = ts[0].dtype if ts else torch.float64
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    if not dtype.is_floating_point:
        dtype = torch.float64
    device = ts[0].device if ts else (generator.device if generator is not None else None)
    return torch.broadcast_tensors(*[torch.as_tensor(p, dtype=dtype, device=device)
                                     for p in params])


def _randn(generator, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)


def _rand(generator, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(like.shape, generator=generator, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class Normal:
    loc: torch.Tensor
    scale: torch.Tensor

    def logpdf(self, y):
        z = (y - self.loc) / self.scale
        return -0.5 * (z * z + _LOG_2PI) - _log(self.scale)

    def sample(self, generator=None):
        loc, scale = _broadcast(generator, self.loc, self.scale)
        return loc + scale * _randn(generator, loc)


@dataclasses.dataclass(frozen=True)
class MvNormal:
    """Multivariate normal over a Cholesky factor; ``FiniteGP.to_mvnormal()``
    returns one (the reference's ``convert(MvNormal, fx)``)."""

    loc: torch.Tensor         # (N,)
    scale_tril: torch.Tensor  # (N, N) lower Cholesky of the covariance

    def logpdf(self, y):
        """Log density of a vector y, or of each column of a matrix Y — the
        same contract as ``FiniteGP.logpdf``."""
        from .ops.blocked_chol import _logpdf_from_chol

        delta = y - (self.loc if y.ndim == 1 else self.loc[:, None])
        return _logpdf_from_chol(self.scale_tril, delta)

    def sample(self, generator=None, num_samples: int | None = None):
        n = self.loc.shape[0]
        cols = 1 if num_samples is None else num_samples
        xi = torch.randn((n, cols), generator=generator, dtype=self.loc.dtype,
                         device=self.loc.device)
        out = self.loc[:, None] + self.scale_tril @ xi
        return out[:, 0] if num_samples is None else out


@dataclasses.dataclass(frozen=True)
class Poisson:
    rate: torch.Tensor

    def logpdf(self, y):
        y = torch.as_tensor(y)
        return y * _log(self.rate) - self.rate - torch.lgamma(y + 1.0)

    def sample(self, generator=None):
        (rate,) = _broadcast(generator, self.rate)
        return torch.poisson(rate, generator=generator)


@dataclasses.dataclass(frozen=True)
class Bernoulli:
    """Parameterised by logits for numerical stability."""

    logits: torch.Tensor

    def logpdf(self, y):
        # y log p + (1-y) log(1-p), computed stably from logits
        (logits,) = _broadcast(None, self.logits)
        return y * logits - torch.logaddexp(torch.zeros_like(logits), logits)

    def sample(self, generator=None):
        (logits,) = _broadcast(generator, self.logits)
        return torch.bernoulli(torch.sigmoid(logits), generator=generator)


@dataclasses.dataclass(frozen=True)
class Exponential:
    rate: torch.Tensor

    def logpdf(self, y):
        return _log(self.rate) - self.rate * y

    def sample(self, generator=None):
        (rate,) = _broadcast(generator, self.rate)
        return torch.empty_like(rate).exponential_(generator=generator) / rate


def _standard_gamma(conc: torch.Tensor, generator) -> torch.Tensor:
    """Gamma(conc, 1) draws by Marsaglia and Tsang's squeeze (conc < 1 by
    Gamma(conc + 1)·U^(1/conc)); every draw comes from ``generator``."""
    boost = conc < 1.0
    a = torch.where(boost, conc + 1.0, conc)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        x = _randn(generator, a)
        v = (1.0 + c * x) ** 3
        u = _rand(generator, a)
        ok = (v > 0.0) & (torch.log(u) < 0.5 * x * x + d - d * v
                          + d * torch.log(torch.clamp(v, min=1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = _rand(generator, a)
    return torch.where(boost, out * u ** (1.0 / conc), out)


@dataclasses.dataclass(frozen=True)
class Gamma:
    concentration: torch.Tensor
    rate: torch.Tensor

    def logpdf(self, y):
        a, b = _broadcast(None, self.concentration, self.rate)
        return a * torch.log(b) + (a - 1.0) * torch.log(y) - b * y - torch.lgamma(a)

    def sample(self, generator=None):
        # draw at the BROADCAST shape of (concentration, rate): a scalar
        # concentration with a vector rate gives independent draws
        conc, rate = _broadcast(generator, self.concentration, self.rate)
        return _standard_gamma(conc, generator) / rate


@dataclasses.dataclass(frozen=True)
class LogNormal:
    loc: torch.Tensor
    scale: torch.Tensor

    def logpdf(self, y):
        ly = torch.log(y)
        z = (ly - self.loc) / self.scale
        return -0.5 * (z * z + _LOG_2PI) - _log(self.scale) - ly

    def sample(self, generator=None):
        loc, scale = _broadcast(generator, self.loc, self.scale)
        return torch.exp(loc + scale * _randn(generator, loc))


@dataclasses.dataclass(frozen=True)
class ProductDistribution:
    """Product of independent scalar distributions as one joint
    distribution: ONE distribution of this module whose parameters are
    batched tensors; the joint ``logpdf`` is the sum of the per-element
    logpdfs and ``sample`` draws the whole batch at once."""

    components: object  # any distribution in this module, batched params

    def logpdf(self, y):
        return torch.sum(self.components.logpdf(y))

    def sample(self, generator=None):
        return self.components.sample(generator)


def product_distribution(components) -> ProductDistribution:
    """``product_distribution(Poisson(rate=λ_vec))`` — joint distribution of
    independent elements."""
    return ProductDistribution(components)
