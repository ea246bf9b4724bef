"""LatentGP — GPs under non-Gaussian likelihoods.

Counterpart of the JAX package's ``models/latent_gp.py`` (reference:
src/latent_gp.jl:1-50). ``LatentGP(f, lik, Σy)`` pairs a GP with a
likelihood map ``lik: latent sample → observation distribution`` (a
distribution of ``distributions``); ``Σy`` is the jitter under which the
latent process is projected. The joint density ``logpdf(lfgp, (f, y)) =
logpdf(fx, f) + logpdf(lik(f), y)`` is the hook for MCMC over latent
functions.
"""

from __future__ import annotations

import torch

from .finite_gp import FiniteGP
from .gp import AbstractGP

__all__ = ["LatentGP", "LatentFiniteGP"]


class LatentGP:
    """``LatentGP(f, lik, Σy)``: ``lik`` maps a latent vector to a
    distribution; a parameterised likelihood closes over its own tensors,
    so gradients reach them through the closure."""

    def __init__(self, f: AbstractGP, lik, noise_var):
        self.f = f
        self.lik = lik
        self.noise_var = noise_var

    def __call__(self, x) -> "LatentFiniteGP":
        # (lgp::LatentGP)(x) projects with jitter (src/latent_gp.jl:30)
        return LatentFiniteGP(self.f(x, self.noise_var), self.lik)


class LatentFiniteGP:
    """``LatentFiniteGP(fx, lik)`` (src/latent_gp.jl:25-28)."""

    def __init__(self, fx: FiniteGP, lik):
        self.fx = fx
        self.lik = lik

    def __len__(self) -> int:
        return len(self.fx)

    def rand(self, generator: torch.Generator | None = None):
        """Joint sample ``{"f": latent, "y": observation}``, both drawn from
        ``generator`` (src/latent_gp.jl:34-38)."""
        f = self.fx.rand(generator)
        y = self.lik(f).sample(generator)
        return {"f": f, "y": y}

    def logpdf(self, fy) -> torch.Tensor:
        """Joint log density log p(y, f; x) (src/latent_gp.jl:48-50); ``fy``
        is a mapping with keys 'f' (latent values) and 'y' (observations)."""
        f, y = fy["f"], fy["y"]
        return self.fx.logpdf(f) + torch.sum(self.lik(f).logpdf(y))
