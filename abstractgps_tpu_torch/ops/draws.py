"""The random draws of the CG probes, the preconditioner's sampler and the
pathwise samplers.

Where the JAX package takes a PRNG key, the port takes a ``torch.Generator``,
an int seed or a draws object: anything with the four methods of
``GeneratorDraws``. The functions draw through it in a fixed order, the
order of the JAX package's draws, so another object can replay another
stream draw for draw (the tests replay the JAX package's own).
"""

from __future__ import annotations

import numbers

import torch

__all__ = ["GeneratorDraws", "as_draws"]


class GeneratorDraws:
    """Every draw from one ``torch.Generator`` (on the device of the tensors
    it makes)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape, dtype, device) -> torch.Tensor:
        """Standard normals: the Woodbury sampler's u and w, the spectral
        frequencies, the prior weights and the observation noise."""
        return torch.randn(shape, generator=self.generator, dtype=dtype, device=device)

    def uniform(self, shape, high: float, dtype, device) -> torch.Tensor:
        """U(0, high): the random-feature phases."""
        return high * torch.rand(shape, generator=self.generator, dtype=dtype, device=device)

    def gamma(self, concentration, shape, dtype, device) -> torch.Tensor:
        """Gamma(concentration, 1): the Matérn χ² and the RQ scale mixture."""
        from ..distributions import _standard_gamma

        conc = torch.as_tensor(concentration, dtype=dtype, device=device).expand(shape)
        return _standard_gamma(conc, self.generator)

    def rademacher(self, shape, dtype, device) -> torch.Tensor:
        """±1 with equal odds: the unpreconditioned CG probes."""
        bits = torch.randint(0, 2, shape, generator=self.generator, device=device)
        return (2 * bits - 1).to(dtype)


def as_draws(source, device):
    """A draws object as it is, or ``GeneratorDraws`` over a generator or
    over a new generator on ``device`` seeded with the given int (None
    means seed 0, the JAX package's default key)."""
    if source is None:
        source = 0
    if isinstance(source, numbers.Integral):
        source = torch.Generator(device=device).manual_seed(int(source))
    if isinstance(source, torch.Generator):
        return GeneratorDraws(source)
    return source
