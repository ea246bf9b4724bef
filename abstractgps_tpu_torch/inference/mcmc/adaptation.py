"""Warmup adaptation: dual-averaging step size + diagonal mass matrix.

Counterpart of the JAX package's ``inference/mcmc/adaptation.py``: Stan's
windowed warmup (the reference's examples run AdvancedHMC's
``StanHMCAdaptor``) — Nesterov dual averaging toward a target acceptance
statistic, and a Welford estimator of the posterior's diagonal covariance
used as the inverse mass matrix, refreshed at the ends of doubling
adaptation windows. States are tuples of tensors; a leading chain
dimension broadcasts through every update. The schedule is host data.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "DualAveragingState",
    "da_init",
    "da_update",
    "WelfordState",
    "welford_init",
    "welford_update",
    "welford_variance",
    "window_schedule",
]


class DualAveragingState(NamedTuple):
    """Nesterov dual averaging (Hoffman & Gelman 2014, eqs. 6-7)."""

    log_step: torch.Tensor      # current log ε
    log_step_avg: torch.Tensor  # averaged log ε (used after warmup)
    gradient_avg: torch.Tensor  # running average of (δ − accept_stat)
    t: torch.Tensor             # iteration counter
    mu: torch.Tensor            # shrinkage target log(10·ε₀)


def da_init(step_size: torch.Tensor) -> DualAveragingState:
    log_step = torch.log(torch.as_tensor(step_size))
    zero = torch.zeros_like(log_step)
    return DualAveragingState(log_step=log_step, log_step_avg=zero, gradient_avg=zero,
                              t=torch.zeros_like(log_step), mu=math.log(10.0) + log_step)


def da_update(state: DualAveragingState, accept_prob: torch.Tensor, target: float = 0.8,
              gamma: float = 0.05, t0: float = 10.0, kappa: float = 0.75) -> DualAveragingState:
    t = state.t + 1.0
    eta = 1.0 / (t + t0)
    g_avg = (1.0 - eta) * state.gradient_avg + eta * (target - accept_prob)
    log_step = state.mu - (torch.sqrt(t) / gamma) * g_avg
    x_eta = t ** (-kappa)
    log_step_avg = x_eta * log_step + (1.0 - x_eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, g_avg, t, state.mu)


class WelfordState(NamedTuple):
    """Running mean/variance estimator for the diagonal mass matrix."""

    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor


def welford_init(dim: int, dtype=torch.float32, device=None, batch: tuple = ()) -> WelfordState:
    """``batch`` is a leading shape, e.g. ``(num_chains,)``."""
    z = torch.zeros((*batch, dim), dtype=dtype, device=device)
    return WelfordState(mean=z, m2=z, count=torch.zeros(batch, dtype=dtype, device=device))


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_variance(state: WelfordState, regularize: bool = True) -> torch.Tensor:
    """Sample variance with Stan's shrinkage toward unity
    (var ← n/(n+5)·var + 1e-3·5/(n+5))."""
    var = state.m2 / torch.clamp(state.count - 1.0, min=1.0)[..., None]
    if regularize:
        n = state.count[..., None]
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def window_schedule(num_warmup: int, init_buffer: int = 75, term_buffer: int = 50,
                    base_window: int = 25):
    """Stan's three-phase warmup schedule.

    Returns (is_window, is_window_end), two (num_warmup,) numpy bool arrays:
    whether step i sits inside a mass-matrix adaptation window, and whether
    it closes one (the mass matrix is refreshed and the Welford state reset
    at window ends).
    """
    is_window = np.zeros(num_warmup, dtype=bool)
    is_end = np.zeros(num_warmup, dtype=bool)
    if num_warmup < init_buffer + term_buffer + base_window:
        # degenerate: single window covering the middle
        lo = min(init_buffer, num_warmup // 3)
        hi = max(lo + 1, num_warmup - min(term_buffer, num_warmup // 3))
        is_window[lo:hi] = True
        if hi - 1 >= 0 and hi - 1 < num_warmup:
            is_end[hi - 1] = True
        return is_window, is_end

    start = init_buffer
    end = num_warmup - term_buffer
    w = base_window
    pos = start
    while pos < end:
        next_pos = pos + w
        if next_pos + 2 * w > end:  # absorb the remainder into the last window
            next_pos = end
        is_window[pos:next_pos] = True
        is_end[next_pos - 1] = True
        pos = next_pos
        w *= 2
    return is_window, is_end
