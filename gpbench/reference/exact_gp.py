"""Plain reference of the exact GP: σ²·k(‖x − x′‖/ℓ) + noise·I, its
negative log marginal likelihood, and the posterior's mean and variance
(Rasmussen & Williams 2006, Algorithm 2.1), written apart from the
program: a dense gram, ``torch.linalg.cholesky`` and triangular solves.
Positive leaves are softplus of their raw values."""

from __future__ import annotations

import math

import torch

from gpbench.numerics import F64, Prec
from gpbench.reference import _adam as adam

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def softplus(v):
    return torch.logaddexp(v, torch.zeros_like(v))


def inv_softplus(v):
    return v + torch.log(-torch.expm1(-v))


def raw_start(inputs: dict, positive, prec: Prec) -> dict:
    """The raw leaves to start from: ``inputs["raw"]`` where it is given (a
    point the program reached), else those at the constrained starting
    values ``inputs["start"]``: softplus⁻¹ of the ``positive`` ones, the rest
    as they are."""
    if "raw" in inputs:
        return {k: prec.cast(v) for k, v in inputs["raw"].items()}
    return {k: (inv_softplus(prec.cast(v)) if k in positive else prec.cast(v))
            for k, v in inputs["start"].items()}


def sqdist(a, b, prec: Prec):
    """‖a_i − b_j‖² from the norms and one matrix product (clamped at 0)."""
    d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * prec.mm(a, b.T)
    return torch.clamp(d2, min=0.0)


def kernel(name: str, d2, s2, ell):
    """σ²·k at squared distance d2 for an isotropic kernel with lengthscale ℓ."""
    if name == "matern32":
        u = _SQRT3 * torch.sqrt(d2) / ell
        return s2 * (1.0 + u) * torch.exp(-u)
    if name == "matern52":
        u = _SQRT5 * torch.sqrt(d2) / ell
        return s2 * (1.0 + u + u * u / 3.0) * torch.exp(-u)
    raise ValueError(f"no reference for kernel {name!r}")


def nlml(cfg: dict, raw: dict, x, y, prec: Prec = F64):
    """−log N(y; 0, K + noise·I) at the raw leaves {ell, noise, s2}."""
    s2, ell, noise = (softplus(raw[k]) for k in ("s2", "ell", "noise"))
    x, y = prec.cast(x), prec.cast(y)
    n = x.shape[0]
    K = kernel(cfg["kernel"], sqdist(x, x, prec), s2, ell)
    K = K + noise * torch.eye(n, dtype=K.dtype, device=K.device)
    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    return 0.5 * (y @ alpha) + torch.log(torch.diagonal(L)).sum() + 0.5 * n * math.log(
        2.0 * math.pi)


def train_steps(cfg: dict, traffic: dict, inputs: dict, prec: Prec = F64) -> dict:
    """Follow the program's first ``steps`` Adam steps from the same start
    on the same data (``inputs``: x, y, steps, and start or raw)."""
    raw0 = raw_start(inputs, ("s2", "ell", "noise"), prec)
    return adam.follow(lambda r: nlml(cfg, r, inputs["x"], inputs["y"], prec), raw0,
                       inputs["steps"], traffic["learning_rate"])


class Posterior:
    """The posterior at fixed hyperparameters: L = chol(K + noise·I) and
    α = K⁻¹y once; each query's cross gram, whitening solve, mean and
    variance in ``prec``."""

    def __init__(self, cfg: dict, inputs: dict, prec: Prec = F64):
        th = inputs["theta"]
        self.cfg, self.prec = cfg, prec
        self.s2, self.ell, noise = (prec.cast(th[k]) for k in ("s2", "ell", "noise"))
        self.x = prec.cast(inputs["x"])
        y = prec.cast(inputs["y"])
        K = kernel(cfg["kernel"], sqdist(self.x, self.x, prec), self.s2, self.ell)
        K = K + noise * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
        self.L = torch.linalg.cholesky(K)
        del K
        self.alpha = torch.cholesky_solve(y[:, None], self.L)[:, 0]

    def mean_and_var(self, xs):
        xs = self.prec.cast(xs)
        Kx = kernel(self.cfg["kernel"], sqdist(self.x, xs, self.prec), self.s2, self.ell)
        mean = self.prec.mm(Kx.T, self.alpha[:, None])[:, 0]
        V = torch.linalg.solve_triangular(self.L, Kx, upper=False)
        var = torch.clamp(self.s2 - (V * V).sum(0), min=0.0)
        return mean, var
