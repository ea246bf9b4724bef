"""Hamiltonian Monte Carlo: leapfrog integrator + fixed-length HMC kernel,
and the samplers' randomness seam.

Counterpart of the JAX package's ``inference/mcmc/hmc.py``. Chains are a
leading batch dimension of every state tensor: positions and gradients
(C, dim), log densities (C,). The log density enters as
``logdensity_and_grad(q, active) -> (logdens (C,), grad (C, dim))``, where
``active`` is a host list of C booleans naming the chains whose values are
used (None: all); a chain that is not active may be left unevaluated, and
its entries are ignored (``sample.logdensity_and_grad`` builds such a
function from a density of one position).

Every random number of a sampler (NUTS, HMC, elliptical slice, SMC) comes
from a draws object, one method per draw site (``GeneratorDraws`` is the
default, backed by one ``torch.Generator``); a transition is a function of
its draws, so another implementation can replay any stream of random
numbers.
"""

from __future__ import annotations

import numbers
from typing import Callable, NamedTuple

import torch

__all__ = [
    "GeneratorDraws",
    "ChainSliceDraws",
    "IntegratorState",
    "leapfrog",
    "kinetic_energy",
    "HMCState",
    "hmc_init",
    "hmc_kernel",
]


class GeneratorDraws:
    """The draw sites of the samplers, from one generator on the positions'
    device. ``active`` (a (C,) bool tensor) names the chains whose draw is
    used; this implementation draws for every chain."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _rand(self, like: torch.Tensor) -> torch.Tensor:
        return torch.rand(like.shape[:1], generator=self.generator, dtype=like.dtype,
                          device=like.device)

    def momentum(self, q: torch.Tensor) -> torch.Tensor:
        """Standard normal (C, dim), before the mass matrix is applied."""
        return torch.randn(q.shape, generator=self.generator, dtype=q.dtype, device=q.device)

    def direction(self, q: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """NUTS: whether each chain's next doubling goes right, (C,) bool."""
        return self._rand(q) < 0.5

    def leaf_uniform(self, q: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """NUTS: U(0, 1) of each leaf's multinomial take, (C,)."""
        return self._rand(q)

    def bias_uniform(self, q: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """NUTS: U(0, 1) of the biased take across doublings, (C,)."""
        return self._rand(q)

    def trajectory_length(self, q: torch.Tensor, high: int) -> torch.Tensor:
        """HMC: leapfrog steps, uniform on [1, high], (C,) int."""
        return torch.randint(1, high + 1, q.shape[:1], generator=self.generator,
                             device=q.device)

    def accept_uniform(self, q: torch.Tensor) -> torch.Tensor:
        """HMC: U(0, 1) of the Metropolis test, (C,)."""
        return self._rand(q)

    def prior(self, sample_prior: Callable, q: torch.Tensor) -> torch.Tensor:
        """ESS: one draw of ``sample_prior(generator)`` a chain, (C, dim)."""
        return torch.stack([sample_prior(self.generator) for _ in range(q.shape[0])]).to(q.dtype)

    def level_uniform(self, q: torch.Tensor) -> torch.Tensor:
        """ESS: U(0, 1) of the slice level, (C,)."""
        return self._rand(q)

    def angle_uniform(self, q: torch.Tensor) -> torch.Tensor:
        """ESS: U(0, 1) of the first angle (scaled to [0, 2π)), (C,)."""
        return self._rand(q)

    def shrink_uniform(self, q: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """ESS: U(0, 1) of the angle redrawn in a shrunk bracket, (C,)."""
        return self._rand(q)

    def resample_uniform(self, w: torch.Tensor) -> torch.Tensor:
        """SMC: the one U(0, 1) offset of systematic resampling, a scalar."""
        return torch.rand((), generator=self.generator, dtype=w.dtype, device=w.device)

    def proposal_normal(self, particles: torch.Tensor) -> torch.Tensor:
        """SMC: standard normal random-walk steps, (N, dim)."""
        return torch.randn(particles.shape, generator=self.generator, dtype=particles.dtype,
                           device=particles.device)

    def move_uniform(self, particles: torch.Tensor) -> torch.Tensor:
        """SMC: U(0, 1) of each particle's Metropolis test, (N,)."""
        return self._rand(particles)


class ChainSliceDraws:
    """The draws of chains ``[start, stop)`` of ``total``: each site draws
    the full (total, ...) batch from ``draws`` and keeps this slice (the
    chain-sharded samplers, one slice a rank). A site's per-chain tensor
    arguments are widened to the full batch: positions with zeros, the
    ``active`` masks with False for the other chains, so a draws object that
    keeps one stream a chain advances exactly the streams of this slice's
    active chains, as in the unsharded run. ``resample_uniform`` (one
    scalar for every particle) passes through."""

    def __init__(self, draws, start: int, stop: int, total: int):
        self.draws, self.start, self.stop, self.total = draws, start, stop, total

    def _widen(self, a):
        if not isinstance(a, torch.Tensor) or a.dim() == 0 or a.shape[0] != self.stop - self.start:
            return a
        out = a.new_zeros((self.total,) + tuple(a.shape[1:]))
        if a.dtype == torch.bool:
            out[self.start:self.stop] = a
        return out

    def __getattr__(self, name):
        if name.startswith("_") or name == "draws":
            raise AttributeError(name)
        site = getattr(self.draws, name)
        if name == "resample_uniform":
            return site
        return lambda *args: site(*(self._widen(a) for a in args))[self.start:self.stop]


def chain_slice(draws, n: int, mesh, mesh_axis: str):
    """(start, stop, draws) of this rank's chains when ``mesh`` shards ``n``
    chains over ``mesh_axis``; (0, n, draws) when ``mesh`` is None."""
    if mesh is None:
        return 0, n, draws
    from ...parallel.mesh import local_block

    start, stop = local_block(n, mesh, mesh_axis)
    return start, stop, ChainSliceDraws(draws, start, stop, n)


def as_generator(generator, device) -> torch.Generator:
    """A ``torch.Generator`` as it is, or one on ``device`` seeded with the
    given int."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


def as_draws(source, device=None):
    """The samplers' randomness: a draws object as it is, or the default one
    over a ``torch.Generator`` or an int seed (a new generator on
    ``device``)."""
    if isinstance(source, (torch.Generator, numbers.Integral)):
        return GeneratorDraws(as_generator(source, device))
    return source


class IntegratorState(NamedTuple):
    q: torch.Tensor        # position (C, dim)
    p: torch.Tensor        # momentum (C, dim)
    logdens: torch.Tensor  # log density at q (C,)
    grad: torch.Tensor     # ∇ log density at q (C, dim)


def select(mask: torch.Tensor, new, old):
    """``where(mask, new, old)`` per chain over tensors or tuples of them
    (``mask`` (C,) broadcasts over the trailing dimensions)."""
    if isinstance(new, tuple):
        return type(new)(*(select(mask, a, b) for a, b in zip(new, old)))
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def step_column(step_size, q: torch.Tensor) -> torch.Tensor:
    """A step size — a scalar, or (C,) one per chain — as a tensor that
    broadcasts against the (C, dim) positions."""
    t = torch.as_tensor(step_size, dtype=q.dtype, device=q.device)
    return t[:, None] if t.ndim == 1 else t


def as_inv_mass(inv_mass, q: torch.Tensor) -> torch.Tensor:
    """A diagonal inverse mass, (dim,) shared or (C, dim) per chain."""
    return torch.as_tensor(inv_mass, dtype=q.dtype, device=q.device)


def leapfrog_step(logdensity_and_grad: Callable, z: IntegratorState, eps: torch.Tensor,
                  inv_mass: torch.Tensor, active=None) -> IntegratorState:
    """One leapfrog step; ``eps`` broadcasts against (C, dim)."""
    p_half = z.p + 0.5 * eps * z.grad
    q = z.q + eps * inv_mass * p_half
    ld, g = logdensity_and_grad(q, active)
    return IntegratorState(q, p_half + 0.5 * eps * g, ld, g)


def leapfrog(logdensity_and_grad: Callable, state: IntegratorState, step_size,
             inv_mass, num_steps) -> IntegratorState:
    """``num_steps`` leapfrog steps with a diagonal (inverse) mass matrix.
    ``num_steps`` is an int, or a (C,) int tensor of per-chain counts (a
    chain stops at its own count; one host read of the counts)."""
    eps = step_column(step_size, state.q)
    inv_mass = as_inv_mass(inv_mass, state.q)
    if isinstance(num_steps, int):
        for _ in range(num_steps):
            state = leapfrog_step(logdensity_and_grad, state, eps, inv_mass)
        return state
    counts = num_steps.tolist()
    for i in range(max(counts, default=0)):
        host = [i < n for n in counts]
        act = torch.tensor(host, device=state.q.device)
        state = select(act, leapfrog_step(logdensity_and_grad, state, eps, inv_mass, host),
                       state)
    return state


def kinetic_energy(p: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(p * p * inv_mass, dim=-1)


class HMCState(NamedTuple):
    q: torch.Tensor
    logdens: torch.Tensor
    grad: torch.Tensor


def hmc_init(logdensity_and_grad: Callable, q0: torch.Tensor) -> HMCState:
    ld, g = logdensity_and_grad(q0, None)
    return HMCState(q0, ld, g)


def hmc_kernel(logdensity_and_grad: Callable, num_integration_steps: int = 32,
               jitter_steps: bool = True):
    """One Metropolis-corrected HMC transition per chain.

    ``jitter_steps`` draws the trajectory length uniformly from
    [1, num_integration_steps] per chain and transition — the guard against
    resonant trajectories on near-Gaussian targets.

    Returns ``step(draws, state, step_size, inv_mass) -> (state, info)``
    with info = (accept_prob, accepted, energy); ``draws`` is a draws object
    or a generator.
    """

    def step(draws, state: HMCState, step_size, inv_mass):
        draws = as_draws(draws)
        q = state.q
        inv_mass = as_inv_mass(inv_mass, q)
        n_steps = (draws.trajectory_length(q, num_integration_steps) if jitter_steps
                   else num_integration_steps)
        # momentum ~ N(0, M) with M = 1/inv_mass (diagonal)
        p0 = draws.momentum(q) / torch.sqrt(inv_mass)
        h0 = -state.logdens + kinetic_energy(p0, inv_mass)
        iend = leapfrog(logdensity_and_grad, IntegratorState(q, p0, state.logdens, state.grad),
                        step_size, inv_mass, n_steps)
        h1 = -iend.logdens + kinetic_energy(iend.p, inv_mass)
        delta_h = h0 - h1
        delta_h = torch.where(torch.isnan(delta_h), -torch.inf, delta_h)
        accept_prob = torch.clamp(torch.exp(delta_h), max=1.0)
        accept = draws.accept_uniform(q) < accept_prob
        new_state = select(accept, HMCState(iend.q, iend.logdens, iend.grad), state)
        return new_state, (accept_prob, accept, h1)

    return step
