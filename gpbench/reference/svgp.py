"""Plain reference of the stochastic variational GP (Hensman, Fusi &
Lawrence 2013, "Gaussian Processes for Big Data"), whitened: ε = L_zz⁻¹u,
q(ε) = N(m, CCᵀ), C lower-triangular with a softplus diagonal, kernel
σ²·exp(−½‖(x − x′)/ℓ‖²) with one ℓ per input dimension. The minibatch
ELBO (B points of n, scaled by n/B) and the predictive mean and variance,
written apart from the program."""

from __future__ import annotations

import math

import torch

from gpbench.numerics import F64, Prec
from gpbench.reference import _adam as adam
from gpbench.reference.exact_gp import raw_start, softplus, sqdist


def _gram(a, b, s2, ard, prec: Prec):
    return s2 * torch.exp(-0.5 * sqdist(a / ard, b / ard, prec))


def _tril(c_raw):
    return torch.tril(c_raw, -1) + torch.diag(softplus(torch.diagonal(c_raw)))


def _predict(st: dict, xs, jitter: float, prec: Prec):
    """(mean, var) of q(f(xs)) at the state {C_raw, ard, m, s2, z}, σ² and ℓ
    constrained."""
    s2, ard, z, m = st["s2"], st["ard"], st["z"], st["m"]
    M = z.shape[0]
    Kzz = _gram(z, z, s2, ard, prec) + jitter * torch.eye(M, dtype=z.dtype, device=z.device)
    Lz = torch.linalg.cholesky(Kzz)
    A = torch.linalg.solve_triangular(Lz, _gram(z, xs, s2, ard, prec), upper=False)
    mean = prec.mm(A.T, m[:, None])[:, 0]
    CtA = prec.mm(_tril(st["C_raw"]).T, A)
    var = torch.clamp(s2 - (A * A).sum(0) + (CtA * CtA).sum(0), min=0.0)
    return mean, var


def neg_elbo(cfg: dict, raw: dict, xb, yb, n_total: int, prec: Prec = F64):
    """−ELBO of one minibatch, the data term scaled by n_total/B."""
    jitter = cfg["model"]["inducing_jitter"]
    st = dict(raw, s2=softplus(raw["s2"]), ard=softplus(raw["ard"]))
    mean, var = _predict(st, xb, jitter, prec)
    noise = softplus(raw["noise2"])
    ell = -0.5 * (torch.log(2.0 * math.pi * noise) + (yb - mean) ** 2 / noise) - var / (
        2.0 * noise)
    C = _tril(raw["C_raw"])
    M = raw["m"].shape[0]
    kl = 0.5 * ((C * C).sum() + raw["m"] @ raw["m"] - M
                - 2.0 * torch.log(torch.diagonal(C)).sum())
    return -(n_total / xb.shape[0] * ell.sum() - kl)


def train_steps(cfg: dict, traffic: dict, inputs: dict, prec: Prec = F64) -> dict:
    """Follow the program's first steps from the same start, each on the
    minibatch rows the program's step drew (``inputs``: x, y, steps,
    batches, and start or raw)."""
    x, y = prec.cast(inputs["x"]), prec.cast(inputs["y"])
    n = x.shape[0]
    raw0 = raw_start(inputs, ("s2", "ard", "noise2"), prec)
    batches = iter(inputs["batches"])

    def loss(raw):
        idx = next(batches).to(x.device)
        return neg_elbo(cfg, raw, x[idx], y[idx], n, prec)

    return adam.follow(loss, raw0, inputs["steps"], traffic["learning_rate"])


class Posterior:
    """q(f(x*)) at a fixed state (``inputs["state"]``: σ², ℓ, z, m, C_raw),
    one query at a time."""

    def __init__(self, cfg: dict, inputs: dict, prec: Prec = F64):
        self.prec = prec
        self.jitter = cfg["model"]["inducing_jitter"]
        self.state = {k: prec.cast(v) for k, v in inputs["state"].items()}

    def mean_and_var(self, xs):
        return _predict(self.state, self.prec.cast(xs), self.jitter, self.prec)
