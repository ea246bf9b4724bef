"""Top-level MCMC runner: windowed warmup + sampling over a batch of chains.

Counterpart of the JAX package's ``inference/mcmc/sample.py`` (the
reference drives AdvancedHMC's ``NUTS`` + ``StanHMCAdaptor`` by hand). Warmup
with Stan's three-phase schedule and the sampling phase are host loops over
a state that stays on the positions' device; chains are its leading
dimension. Parameters are flat vectors inside (``params.ravel``); the API
takes a tree position (a tensor, or dicts, lists and tuples of them) and
returns samples in the same tree (leading dims (num_chains, num_samples)).

How the chains meet the log density is the keyword ``chain_eval``, the
port's form of the JAX package's ``vmap``:

- ``"vmap"``: ``torch.func.vmap(torch.func.grad_and_value(...))`` over the
  chains, for pure-torch densities. A density that cannot be vmapped (the
  fused GP logpdf: its autograd Functions launch kernels) raises, naming
  ``chain_eval="loop"``.
- ``"loop"``: each active chain's density and ``torch.autograd.grad`` in
  turn; a chain the masks have stopped is not evaluated, and no graph
  outlives its gradient. This is the mode of the GP hyperparameter
  density on the fused path.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ...params import leaves, ravel, with_leaves
from .adaptation import (
    da_init,
    da_update,
    welford_init,
    welford_update,
    welford_variance,
    window_schedule,
)
from .hmc import as_draws, as_generator, chain_slice, hmc_init, hmc_kernel
from .nuts import NUTSInfo, nuts_kernel

__all__ = ["MCMCResult", "run_mcmc", "init_chain_positions", "logdensity_and_grad",
           "chain_values"]

CHAIN_EVALS = ("vmap", "loop")


class MCMCResult(NamedTuple):
    positions: object           # tree; leaves (num_chains, num_samples, ...)
    logdens: torch.Tensor       # (num_chains, num_samples)
    accept_prob: torch.Tensor   # (num_chains, num_samples)
    num_steps: torch.Tensor     # (num_chains, num_samples) leapfrog steps/draw
    diverging: torch.Tensor     # (num_chains, num_samples)
    step_size: torch.Tensor     # (num_chains,) adapted ε
    inv_mass: torch.Tensor      # (num_chains, dim) adapted M⁻¹ diagonal


def _check_chain_eval(chain_eval: str) -> None:
    if chain_eval not in CHAIN_EVALS:
        raise ValueError(f"chain_eval must be one of {CHAIN_EVALS}, got {chain_eval!r}")


def _vmap_error(err: Exception) -> RuntimeError:
    return RuntimeError(
        "chain_eval='vmap' could not vmap the log density over the chains "
        f"({type(err).__name__}: {err}); a density that launches the port's kernels "
        "(the fused GP logpdf) needs chain_eval='loop'")


def chain_values(fn: Callable, chain_eval: str) -> Callable:
    """``values(q, active) -> (C,)``: ``fn`` of one (dim,) position at each
    row of q (no gradient), by ``chain_eval``; ``active`` is a host list of
    booleans (None: all), and an inactive chain's entry is 0."""
    _check_chain_eval(chain_eval)
    if chain_eval == "vmap":
        vfn = torch.func.vmap(fn)

        def values(q, active=None):
            try:
                return vfn(q)
            except Exception as err:
                raise _vmap_error(err) from err
        return values

    def values_loop(q, active=None):
        out = torch.zeros(q.shape[0], dtype=q.dtype, device=q.device)
        for c in range(q.shape[0]):
            if active is None or active[c]:
                out[c] = fn(q[c])
        return out
    return values_loop


def logdensity_and_grad(logdensity: Callable, unravel: Callable, chain_eval: str) -> Callable:
    """The samplers' ``(q, active) -> (logdens (C,), grad (C, dim))`` for
    ``logdensity`` of one tree position, by ``chain_eval``. The NaN guard of
    the JAX package: a NaN log density becomes −inf (a rejection), a
    non-finite gradient entry becomes 0."""
    _check_chain_eval(chain_eval)

    def flat(q):
        return logdensity(unravel(q))

    def guard(ld, g):
        ld = torch.where(torch.isnan(ld), -torch.inf, ld)
        return ld, torch.where(torch.isfinite(g), g, torch.zeros_like(g))

    if chain_eval == "vmap":
        vgrad = torch.func.vmap(torch.func.grad_and_value(flat))

        def ld_and_grad_vmap(q, active=None):
            try:
                g, ld = vgrad(q)
            except Exception as err:
                raise _vmap_error(err) from err
            return guard(ld.to(q.dtype), g)
        return ld_and_grad_vmap

    def ld_and_grad_loop(q, active=None):
        lds = torch.zeros(q.shape[0], dtype=q.dtype, device=q.device)
        gs = torch.zeros_like(q)
        for c in range(q.shape[0]):
            if active is not None and not active[c]:
                continue
            qc = q[c].detach().requires_grad_()
            with torch.enable_grad():
                ld = flat(qc)
                if ld.requires_grad:
                    (g,) = torch.autograd.grad(ld, qc, allow_unused=True)
                else:
                    g = None
            lds[c] = ld.detach()
            if g is not None:
                gs[c] = g
        return guard(lds, gs)
    return ld_and_grad_loop


def _flatten_chains(init_position, num_chains):
    """The init tree as (n_chains, dim), and one chain's tree.
    ``num_chains=None``: the tree is one (chain-free) position; otherwise
    every leaf carries a leading ``num_chains`` axis (as
    ``init_chain_positions`` builds it)."""
    if num_chains is None:
        return ravel(init_position)[0].detach()[None, :], init_position
    ls = leaves(init_position)
    flat0 = torch.cat([t.detach().reshape(t.shape[0], -1) for t in ls], dim=1)
    if flat0.shape[0] != num_chains:
        raise ValueError(f"init_position has leading dim {flat0.shape[0]}, expected "
                         f"num_chains={num_chains}")
    return flat0, with_leaves(init_position, [t[0] for t in ls])


def _unravel_draws(template, shapes, qs: torch.Tensor):
    """(..., dim) flat positions → the template's tree, its leaves with the
    leading dimensions of ``qs`` (``shapes``: the leaves' own shapes)."""
    parts, i = [], 0
    for shp in shapes:
        k = shp.numel()
        parts.append(qs[..., i:i + k].reshape(qs.shape[:-1] + shp))
        i += k
    return with_leaves(template, parts)


def init_chain_positions(generator, position, num_chains: int, jitter: float = 1.0):
    """Broadcast one tree position to ``num_chains`` jittered copies
    (uniform(−jitter, jitter) in flat space, Stan's default init style);
    ``generator`` is a ``torch.Generator`` or a seed, on the position's
    device."""
    flat, _ = ravel(position)
    flat = flat.detach()
    gen = as_generator(generator, flat.device)
    noise = torch.rand((num_chains, flat.shape[0]), generator=gen, dtype=flat.dtype,
                       device=flat.device) * (2.0 * jitter) - jitter
    return _unravel_draws(position, [t.shape for t in leaves(position)],
                          flat[None, :] + noise)


def run_mcmc(logdensity: Callable, init_position, generator, *, num_samples: int = 1000,
             num_warmup: int = 1000, num_chains: int | None = None, algorithm: str = "nuts",
             max_depth: int = 10, num_integration_steps: int = 32,
             initial_step_size: float = 0.1, target_accept: float = 0.8, thin: int = 1,
             chain_eval: str = "vmap", mesh=None, mesh_axis: str = "dp") -> MCMCResult:
    """Run NUTS (or fixed-length HMC) over ``logdensity``.

    ``init_position`` is a tree whose leaves carry a leading chain axis
    (build one with ``init_chain_positions``); pass a chain-free tree for a
    single chain. ``logdensity`` maps the (chain-free) tree to a scalar.
    ``generator`` is a ``torch.Generator`` or a seed, on the positions'
    device (or a draws object, ``hmc.GeneratorDraws``); every state tensor
    stays on that device.

    ``chain_eval``: ``"vmap"`` (pure-torch densities; raises, naming
    ``"loop"``, on a density that cannot be vmapped) or ``"loop"`` (each
    active chain in turn with ``torch.autograd.grad``: densities that launch
    the port's kernels, such as the GP logpdf on the fused path).

    ``mesh``: optional ``DeviceMesh`` (``parallel.make_mesh``); the chains
    are sharded over ``mesh_axis`` (``num_chains`` must divide by its
    size): each rank runs its own block of chains, with no collective at
    all, warmup included, and its result holds those chains (gathering them
    is the caller's business). Every rank draws the full batch of random
    numbers and keeps its chains' (``hmc.ChainSliceDraws``).

    The JAX package's ``segment_size``/``program_cache`` bound a compiled
    device program, which eager torch does not build.
    """
    if num_samples < 1:
        raise ValueError(f"num_samples must be at least 1, got {num_samples}")
    flat0, one = _flatten_chains(init_position, num_chains)
    _, unravel = ravel(one)
    dtype, dev = flat0.dtype, flat0.device
    start, stop, draws = chain_slice(as_draws(generator, dev), flat0.shape[0], mesh, mesh_axis)
    flat0 = flat0[start:stop]
    n_chains, dim = flat0.shape
    ld_and_grad = logdensity_and_grad(logdensity, unravel, chain_eval)

    if algorithm == "nuts":
        kernel = nuts_kernel(ld_and_grad, max_depth=max_depth)
    elif algorithm == "hmc":
        kernel = hmc_kernel(ld_and_grad, num_integration_steps=num_integration_steps)
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")

    def accept_of(info):
        return info.accept_prob if isinstance(info, NUTSInfo) else info[0]

    is_window, is_window_end = window_schedule(num_warmup)
    with torch.no_grad():
        state = hmc_init(ld_and_grad, flat0)
        da = da_init(torch.full((n_chains,), initial_step_size, dtype=dtype, device=dev))
        wf = welford_init(dim, dtype, dev, (n_chains,))
        inv_mass = torch.ones((n_chains, dim), dtype=dtype, device=dev)
        for i in range(num_warmup):
            state, info = kernel(draws, state, torch.exp(da.log_step), inv_mass)
            da = da_update(da, accept_of(info), target=target_accept)
            if is_window[i]:
                wf = welford_update(wf, state.q)
            if is_window_end[i]:
                inv_mass = welford_variance(wf)
                # re-init dual averaging around the current step size
                da = da_init(torch.exp(da.log_step))
                wf = welford_init(dim, dtype, dev, (n_chains,))
        step_sizes = torch.exp(da.log_step_avg)

        outs = []
        for _ in range(num_samples):
            for _ in range(thin):
                state, info = kernel(draws, state, step_sizes, inv_mass)
            if isinstance(info, NUTSInfo):
                n_steps, div = info.num_steps, info.diverging
            else:  # hmc: (accept_prob, accepted, energy)
                n_steps = torch.full((n_chains,), num_integration_steps, device=dev)
                div = torch.zeros((n_chains,), dtype=torch.bool, device=dev)
            outs.append((state.q, state.logdens, accept_of(info), n_steps, div))

    qs, lds, aps, nss, divs = (torch.stack(col, dim=1) for col in zip(*outs))
    positions = _unravel_draws(one, [t.shape for t in leaves(one)], qs)
    return MCMCResult(positions=positions, logdens=lds, accept_prob=aps, num_steps=nss,
                      diverging=divs, step_size=step_sizes, inv_mass=inv_mass)
