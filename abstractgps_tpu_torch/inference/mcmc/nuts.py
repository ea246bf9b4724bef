"""NUTS: iterative multinomial No-U-Turn sampler over a batch of chains.

Counterpart of the JAX package's ``inference/mcmc/nuts.py`` (the
reference runs AdvancedHMC's multinomial NUTS with the generalized no-U-turn
criterion):

- iterative tree building with the trailing-bit checkpoint scheme (a
  (max_depth, dim) checkpoint buffer per chain instead of recursion);
- multinomial progressive sampling within subtrees, biased progressive
  sampling across doublings (Betancourt 2017, App. A.3.2);
- the generalized U-turn criterion on the momentum sum.

Chains are the leading dimension of every state tensor. The JAX package's
two ``lax.while_loop``s under ``vmap`` are two Python loops here, each
running while any chain is active and masking finished chains with
``torch.where``. Active chains share the tree depth and the leaf counter,
so the checkpoint range of a leaf is host integer arithmetic and the
turning check over it is one masked reduction. A leaf costs one
device-to-host read: the mask of active chains, which also tells a
``chain_eval="loop"`` density which chains to evaluate.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .hmc import (
    HMCState,
    IntegratorState,
    as_draws,
    as_inv_mass,
    kinetic_energy,
    leapfrog_step,
    select,
    step_column,
)

__all__ = ["NUTSInfo", "nuts_kernel"]


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # mean acceptance statistic (for dual averaging)
    num_steps: torch.Tensor    # leapfrog steps taken this transition
    depth: torch.Tensor        # tree depth reached
    diverging: torch.Tensor    # bool: transition ended in divergence
    energy: torch.Tensor       # -logdens + kinetic at the initial point


def _is_turning(p_left, p_right, p_sum, inv_mass):
    """Generalized no-U-turn criterion on a (sub)trajectory, over the last
    dimension."""
    return ((torch.sum(p_sum * (inv_mass * p_left), dim=-1) <= 0.0)
            | (torch.sum(p_sum * (inv_mass * p_right), dim=-1) <= 0.0))


def _leaf_to_ckpt_idxs(n: int):
    """Checkpoint range covered by odd leaf ``n`` (trailing-bit trick):
    idx_max = number of set bits in n >> 1; idx_min = idx_max − (number of
    trailing set bits of n) + 1."""
    idx_max = bin(n >> 1).count("1")
    trailing = 0
    while (n >> trailing) & 1:
        trailing += 1
    return idx_max - trailing + 1, idx_max


def _iterative_turning_check(p_ckpts, psum_ckpts, p_leaf, p_sum, inv_mass, idx_min, idx_max):
    """U-turn between the current (odd) leaf and any checkpointed subtree
    start in [idx_min, idx_max]: one reduction over that range.
    ``psum_ckpts[:, i]`` holds the subtree momentum sum inclusive of
    checkpoint leaf i, so the span sum over leaves [ckpt..current] is
    ``p_sum − psum_ckpts[:, i] + p_ckpts[:, i]``."""
    ck = p_ckpts[:, idx_min:idx_max + 1]
    span = p_sum[:, None] - psum_ckpts[:, idx_min:idx_max + 1] + ck
    im = inv_mass[:, None] if inv_mass.ndim == 2 else inv_mass
    return torch.any(_is_turning(ck, p_leaf[:, None], span, im), dim=1)


class _Subtree(NamedTuple):
    z: IntegratorState       # current end of the subtree
    prop_z: IntegratorState  # multinomial proposal within the subtree
    log_sum_w: torch.Tensor
    p_sum: torch.Tensor
    accept_sum: torch.Tensor
    leaves: torch.Tensor     # leaves taken, per chain
    turning: torch.Tensor
    diverging: torch.Tensor


def nuts_kernel(logdensity_and_grad: Callable, max_depth: int = 10,
                divergence_threshold: float = 1000.0):
    """One multinomial-NUTS transition per chain.

    Returns ``step(draws, state, step_size, inv_mass) -> (HMCState,
    NUTSInfo)``; ``draws`` is a draws object (``hmc.GeneratorDraws``) or a
    generator, ``step_size`` a scalar or (C,), ``inv_mass`` (dim,) or
    (C, dim).
    """

    def step(draws, state: HMCState, step_size, inv_mass):
        draws = as_draws(draws)
        q0 = state.q
        n_chains, dim = q0.shape
        dtype, dev = q0.dtype, q0.device
        eps0 = step_column(step_size, q0)
        inv_mass = as_inv_mass(inv_mass, q0)

        def energy(z: IntegratorState):
            return -z.logdens + kinetic_energy(z.p, inv_mass)

        def build_subtree(z_start, direction, depth, h0, active, active_host):
            """Integrate up to ``2^depth`` leaves from z_start in
            ``direction`` for the active chains; a chain stops at an
            internal U-turn or a divergence."""
            eps = direction[:, None] * eps0
            ckpt = torch.zeros((n_chains, max_depth, dim), dtype=dtype, device=dev)
            p_ckpts, psum_ckpts = ckpt, ckpt.clone()
            s = _Subtree(z=z_start, prop_z=z_start,
                         log_sum_w=torch.full((n_chains,), -torch.inf, dtype=dtype, device=dev),
                         p_sum=torch.zeros_like(q0),
                         accept_sum=torch.zeros((n_chains,), dtype=dtype, device=dev),
                         leaves=torch.zeros((n_chains,), dtype=torch.int64, device=dev),
                         turning=torch.zeros((n_chains,), dtype=torch.bool, device=dev),
                         diverging=torch.zeros((n_chains,), dtype=torch.bool, device=dev))
            act, act_host = active, active_host
            for leaf in range(1 << depth):
                if leaf:
                    act = active & ~(s.turning | s.diverging)
                    act_host = act.tolist()
                    if not any(act_host):
                        break
                z = leapfrog_step(logdensity_and_grad, s.z, eps, inv_mass, act_host)
                delta_h = h0 - energy(z)  # log weight of this leaf
                delta_h = torch.where(torch.isnan(delta_h), -torch.inf, delta_h)
                log_sum_w = torch.logaddexp(s.log_sum_w, delta_h)
                # progressive multinomial sampling within the subtree
                take = torch.log(draws.leaf_uniform(q0, act)) < delta_h - log_sum_w
                p_sum = s.p_sum + z.p
                # trailing-bit checkpoint bookkeeping (leaf is shared by the
                # active chains)
                idx_min, idx_max = _leaf_to_ckpt_idxs(leaf)
                every = all(act_host)  # no chain to hold back: skip the masks
                if leaf % 2 == 0:
                    p_ckpts[:, idx_max] = z.p if every else select(act, z.p, p_ckpts[:, idx_max])
                    psum_ckpts[:, idx_max] = (p_sum if every
                                              else select(act, p_sum, psum_ckpts[:, idx_max]))
                    turning = s.turning
                else:
                    turning = _iterative_turning_check(p_ckpts, psum_ckpts, z.p, p_sum,
                                                       inv_mass, idx_min, idx_max)
                new = _Subtree(
                    z=z, prop_z=select(take, z, s.prop_z), log_sum_w=log_sum_w, p_sum=p_sum,
                    accept_sum=s.accept_sum + torch.clamp(torch.exp(delta_h), max=1.0),
                    leaves=s.leaves + 1, turning=turning,
                    diverging=delta_h < -divergence_threshold)
                s = new if every else select(act, new, s)
            return s

        # ---------------- main doubling loop ----------------
        p0 = draws.momentum(q0) / torch.sqrt(inv_mass)
        z0 = IntegratorState(q0, p0, state.logdens, state.grad)
        h0 = energy(z0)
        zeros = torch.zeros((n_chains,), dtype=dtype, device=dev)
        false = torch.zeros((n_chains,), dtype=torch.bool, device=dev)
        z_left = z_right = prop_z = z0
        log_sum_w, p_sum, accept_sum = zeros, p0, zeros  # log w(z0) = h0 - h0 = 0
        depth = num_steps = torch.zeros((n_chains,), dtype=torch.int64, device=dev)
        turning = diverging = false
        active = ~false
        active_host = [True] * n_chains
        for d in range(max_depth):
            if d:
                active = ~(turning | diverging)
                active_host = active.tolist()
                if not any(active_host):
                    break
            going_right = draws.direction(q0, active)
            direction = torch.where(going_right, 1.0, -1.0).to(dtype)
            z_start = select(going_right, z_right, z_left)
            sub = build_subtree(z_start, direction, d, h0, active, active_host)
            sub_ok = ~(sub.turning | sub.diverging)

            # biased progressive sampling across doublings
            take_new = sub_ok & (torch.log(draws.bias_uniform(q0, active))
                                 < sub.log_sum_w - log_sum_w)
            new_prop = select(take_new, sub.prop_z, prop_z)
            # merge trajectory stats (only when the subtree completed)
            new_lsw = torch.where(sub_ok, torch.logaddexp(log_sum_w, sub.log_sum_w), log_sum_w)
            new_psum = torch.where(sub_ok[:, None], p_sum + sub.p_sum, p_sum)
            new_right = select(sub_ok & going_right, sub.z, z_right)
            new_left = select(sub_ok & ~going_right, sub.z, z_left)
            # an incomplete subtree terminates the trajectory
            global_turning = torch.where(sub_ok, _is_turning(new_left.p, new_right.p, new_psum,
                                                             inv_mass), True)

            prop_z = select(active, new_prop, prop_z)
            log_sum_w = torch.where(active, new_lsw, log_sum_w)
            p_sum = select(active, new_psum, p_sum)
            z_right = select(active, new_right, z_right)
            z_left = select(active, new_left, z_left)
            turning = torch.where(active, sub.turning | global_turning, turning)
            diverging = torch.where(active, sub.diverging, diverging)
            accept_sum = torch.where(active, accept_sum + sub.accept_sum, accept_sum)
            num_steps = torch.where(active, num_steps + sub.leaves, num_steps)
            depth = depth + active

        new_state = HMCState(prop_z.q, prop_z.logdens, prop_z.grad)
        accept_prob = accept_sum / torch.clamp(num_steps.to(dtype), min=1.0)
        return new_state, NUTSInfo(accept_prob=accept_prob, num_steps=num_steps, depth=depth,
                                   diverging=diverging, energy=h0)

    return step
