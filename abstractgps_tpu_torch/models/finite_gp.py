"""FiniteGP — the finite-dimensional projection of a GP.

Reference: src/finite_gp_projection.jl:1-339. A FiniteGP is the multivariate
normal ``f(x) + ε``, ``ε ~ N(0, Σy)``, with the Primary Public API
(rand / logpdf / marginals / mean / var / posterior) and the Secondary API
(cov / mean_and_cov). Sampling takes an explicit ``torch.Generator``. The
Cholesky factorisation of ``cov(fx)`` is the single O(N³) hot spot; for a
kernel prior with diagonal noise on the card (f32, N ≥ 1024) it runs the
fused gram→Cholesky sweep of ``ops.blocked_chol``, where K never exists in
device memory.
"""

from __future__ import annotations

import math

import torch

from ..ops import covmat
from ..ops.distance import as_tensor
from ..ops.noise import Noise, as_noise
from ..ops.precision import precise
from ..utils.profiling import span
from .gp import AbstractGP

__all__ = [
    "FiniteGP",
    "rand",
    "logpdf",
    "loglikelihood",
    "marginals",
    "sqmahal",
    "gradlogpdf",
]

_LOG_2PI = math.log(2.0 * math.pi)


class FiniteGP:
    """``FiniteGP(f, x, Σy)``."""

    def __init__(self, f: AbstractGP, x: torch.Tensor, noise: Noise):
        self.f = f
        self.x = x  # (N, D)
        self.noise = noise

    @staticmethod
    def create(f: AbstractGP, x: torch.Tensor, noise=None) -> "FiniteGP":
        """Normalising constructor: scalar/vector/matrix/None noise (default
        σ² = 1e-18); non-tensor noise takes x's dtype and device."""
        return FiniteGP(f, x, as_noise(noise, x.shape[0], like=x))

    def __len__(self) -> int:
        return self.x.shape[0]

    # -- moments -------------------------------------------------------------

    def mean(self) -> torch.Tensor:
        return self.f.mean(self.x)

    @precise
    def cov(self, other: "FiniteGP | None" = None) -> torch.Tensor:
        if other is not None:
            return self.f.cov(self.x, other.x)
        return self.noise.add_to(self.f.cov(self.x))

    @precise
    def var(self) -> torch.Tensor:
        return self.f.var(self.x) + self.noise.diag()

    @precise
    def mean_and_cov(self):
        m, C = self.f.mean_and_cov(self.x)
        return m, self.noise.add_to(C)

    @precise
    def mean_and_var(self):
        m, v = self.f.mean_and_var(self.x)
        return m, v + self.noise.diag()

    def marginals(self):
        """Per-point Normal marginals as (means, stds)."""
        m, v = self.mean_and_var()
        return m, torch.sqrt(v)

    # -- internals -----------------------------------------------------------

    def _fused_gram_args(self):
        """The single gate for the fused gram→Cholesky paths: ``(kernel,
        noise diagonal)`` for a kernel-based GP prior with diagonal-structured
        noise at size on the card, else None."""
        from ..ops import blocked_chol
        from ..ops.noise import DenseNoise
        from .gp import GP

        if isinstance(self.f, GP) and not isinstance(self.noise, DenseNoise):
            nd = self.noise.diag().to(device=self.x.device, dtype=self.x.dtype)
            if blocked_chol.should_use_fused_gram(self.x, nd):
                return self.f.kernel, nd
        return None

    @precise
    def _chol(self):
        """(mean, chol(cov)) — the O(N³) hot spot."""
        from ..ops import blocked_chol

        fused = self._fused_gram_args()
        if fused is not None:
            kernel, nd = fused
            return self.f.mean(self.x), blocked_chol.cholesky_gram(kernel, self.x, nd)
        m, C = self.mean_and_cov()
        return m, covmat.cholesky_lower(C)

    # -- sampling ------------------------------------------------------------

    @precise
    def rand(self, generator: torch.Generator | None = None,
             num_samples: int | None = None) -> torch.Tensor:
        """Joint samples ``m + L·ξ``: ``None`` → (N,), int n → (N, n). ξ is
        drawn from ``generator`` (on the inputs' device)."""
        m, L = self._chol()
        cols = 1 if num_samples is None else num_samples
        xi = torch.randn((m.shape[0], cols), generator=generator, dtype=m.dtype,
                         device=m.device)
        out = m[:, None] + L @ xi
        return out[:, 0] if num_samples is None else out

    # -- densities -----------------------------------------------------------

    @precise
    def logpdf(self, y) -> torch.Tensor:
        """Log density of a vector y, or of each column of a matrix Y. On the
        fused path this is one op (``blocked_chol.gram_logpdf_core``): the
        gram→Cholesky sweep with the whitening solve riding it."""
        from ..ops import blocked_chol

        with span("model.logpdf"):
            y = as_tensor(y)
            fused = self._fused_gram_args()
            if fused is not None:
                kernel, nd = fused
                m = self.f.mean(self.x)
                delta = y - (m if y.ndim == 1 else m[:, None])
                return blocked_chol.gram_logpdf_core(kernel, self.x, nd, delta)
            m, L = self._chol()
            quad = _sqmahal(m, L, y)
            return -0.5 * ((y.shape[0] * _LOG_2PI + covmat.logdet_from_chol(L)) + quad)

    @precise
    def loglikelihood(self, Y) -> torch.Tensor:
        """Sum of per-column logpdfs."""
        return torch.sum(self.logpdf(Y))

    @precise
    def logdetcov(self) -> torch.Tensor:
        _, L = self._chol()
        return covmat.logdet_from_chol(L)

    @precise
    def sqmahal(self, y) -> torch.Tensor:
        """Squared Mahalanobis distance."""
        m, L = self._chol()
        return _sqmahal(m, L, as_tensor(y))

    @precise
    def gradlogpdf(self, y) -> torch.Tensor:
        """∇_y log p(y) = Σ⁻¹(m − y)."""
        m, L = self._chol()
        return covmat.chol_solve(L, m - as_tensor(y))

    @precise
    def invcov(self) -> torch.Tensor:
        """Precision matrix."""
        _, L = self._chol()
        return covmat.chol_solve(L, torch.eye(L.shape[0], dtype=L.dtype, device=L.device))

    def params(self):
        """(f, x, Σy)."""
        return self.f, self.x, self.noise

    @precise
    def to_mvnormal(self):
        """Decouple into a plain ``MvNormal(m, L)`` distribution — the
        reference's ``convert(MvNormal, fx)``."""
        from ..distributions import MvNormal

        m, L = self._chol()
        return MvNormal(m, L)

    def posterior(self, y):
        from .exact_posterior import posterior

        return posterior(self, y)


def _sqmahal(m: torch.Tensor, L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """tr/diag Xt_invA_X dispatch on vector vs. matrix y."""
    if y.ndim == 1:
        return covmat.tr_Xt_invA_X(L, y - m)
    return covmat.diag_Xt_invA_X(L, y - m[:, None])


# ---------------------------------------------------------------------------
# Reference-named free functions
# ---------------------------------------------------------------------------


def rand(generator: torch.Generator | None, fx: FiniteGP,
         num_samples: int | None = None) -> torch.Tensor:
    return fx.rand(generator, num_samples)


def logpdf(fx: FiniteGP, y) -> torch.Tensor:
    return fx.logpdf(y)


def loglikelihood(fx: FiniteGP, Y) -> torch.Tensor:
    return fx.loglikelihood(Y)


def marginals(fx: FiniteGP):
    return fx.marginals()


def sqmahal(fx: FiniteGP, y) -> torch.Tensor:
    return fx.sqmahal(y)


def gradlogpdf(fx: FiniteGP, y) -> torch.Tensor:
    return fx.gradlogpdf(y)
