"""Structured observation-noise covariance Σy.

Σy is one of ``Fill(σ², n)`` (isotropic), ``Diagonal(σ²vec)``
(heteroscedastic) or a dense matrix, as in the JAX package's
``ops/noise.py``; the three classes share one interface.
"""

from __future__ import annotations

import torch

from . import covmat
from .distance import as_tensor

__all__ = [
    "DEFAULT_NOISE_VARIANCE",
    "IsotropicNoise",
    "DiagonalNoise",
    "DenseNoise",
    "as_noise",
    "noise_block_diag",
]

DEFAULT_NOISE_VARIANCE = 1e-18  # reference default σ²


class IsotropicNoise:
    """``σ² I_n``."""

    def __init__(self, variance, n: int):
        self.variance = variance  # 0-dim tensor
        self.n = n

    def add_to(self, K: torch.Tensor) -> torch.Tensor:
        return K + self.variance * torch.eye(self.n, dtype=K.dtype,
                                             device=K.device)

    def diag(self) -> torch.Tensor:
        return self.variance.expand(self.n)

    def dense(self, dtype=None) -> torch.Tensor:
        return self.variance * torch.eye(
            self.n, dtype=dtype or self.variance.dtype,
            device=self.variance.device)

    def chol_diag(self) -> torch.Tensor:
        return torch.sqrt(self.diag())

    def logdet(self) -> torch.Tensor:
        return self.n * torch.log(self.variance)

    def solve_sqrt(self, B: torch.Tensor) -> torch.Tensor:
        return B / torch.sqrt(self.variance)

    def tr_solve(self, diag_Cf: torch.Tensor) -> torch.Tensor:
        return torch.sum(diag_Cf) / self.variance


class DiagonalNoise:
    """``Diagonal(σ²vec)``."""

    def __init__(self, variances):
        self.variances = variances  # (n,)

    @property
    def n(self) -> int:
        return self.variances.shape[0]

    def add_to(self, K: torch.Tensor) -> torch.Tensor:
        return K + torch.diag(self.variances.to(K.dtype))

    def diag(self) -> torch.Tensor:
        return self.variances

    def dense(self, dtype=None) -> torch.Tensor:
        return torch.diag(self.variances.to(dtype) if dtype else self.variances)

    def chol_diag(self) -> torch.Tensor:
        return torch.sqrt(self.variances)

    def logdet(self) -> torch.Tensor:
        return torch.sum(torch.log(self.variances))

    def solve_sqrt(self, B: torch.Tensor) -> torch.Tensor:
        s = torch.sqrt(self.variances)
        return B / (s if B.ndim == 1 else s[:, None])

    def tr_solve(self, diag_Cf: torch.Tensor) -> torch.Tensor:
        return torch.sum(diag_Cf / self.variances)


class DenseNoise:
    """Full correlated noise covariance matrix."""

    def __init__(self, cov):
        self.cov = cov  # (n, n)

    @property
    def n(self) -> int:
        return self.cov.shape[0]

    def add_to(self, K: torch.Tensor) -> torch.Tensor:
        return K + self.cov

    def diag(self) -> torch.Tensor:
        return torch.diagonal(self.cov)

    def dense(self, dtype=None) -> torch.Tensor:
        return self.cov.to(dtype) if dtype else self.cov

    def _chol(self) -> torch.Tensor:
        return covmat.cholesky_lower(self.cov)

    def chol_diag(self) -> torch.Tensor:
        return torch.diagonal(self._chol())

    def logdet(self) -> torch.Tensor:
        return covmat.logdet_from_chol(self._chol())

    def solve_sqrt(self, B: torch.Tensor) -> torch.Tensor:
        return covmat.solve_lower(self._chol(), B)

    def tr_solve(self, diag_Cf: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "tr(Cf Σy⁻¹) with dense Σy is unsupported, matching the reference "
            "(sparse approximations require Diagonal/Isotropic noise)."
        )


Noise = IsotropicNoise | DiagonalNoise | DenseNoise


def noise_block_diag(a: Noise, b: Noise) -> Noise:
    """Block-diagonal concatenation of two noise covariances
    (diag ⊕ diag → diag; anything with a dense part → dense)."""
    if isinstance(a, DenseNoise) or isinstance(b, DenseNoise):
        return DenseNoise(torch.block_diag(a.dense(), b.dense()))
    return DiagonalNoise(torch.cat([a.diag(), b.diag()]))


def as_noise(sigma2, n: int, like: torch.Tensor | None = None) -> Noise:
    """Normalise user noise input to a Noise object.

    Accepts ``None`` (default jitter 1e-18), a scalar, an (n,) vector, an
    (n, n) matrix, or an existing Noise object. Non-tensor values take the
    dtype and device of ``like`` (the inputs) when given.
    """
    if isinstance(sigma2, (IsotropicNoise, DiagonalNoise, DenseNoise)):
        return sigma2
    if sigma2 is None:
        sigma2 = DEFAULT_NOISE_VARIANCE
    if isinstance(sigma2, torch.Tensor) or like is None:
        arr = as_tensor(sigma2)
    else:
        arr = as_tensor(sigma2, dtype=like.dtype, device=like.device)
    if arr.ndim == 0:
        return IsotropicNoise(arr, n)
    if arr.ndim == 1:
        if arr.shape[0] != n:
            raise ValueError(f"noise vector length {arr.shape[0]} != n ({n})")
        return DiagonalNoise(arr)
    if arr.ndim == 2:
        if tuple(arr.shape) != (n, n):
            raise ValueError(f"noise matrix shape {tuple(arr.shape)} != ({n}, {n})")
        return DenseNoise(arr)
    raise ValueError(f"cannot interpret noise of ndim {arr.ndim}")
