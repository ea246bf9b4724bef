"""Streaming (online) exact GP conditioning into a fixed-capacity cache.

Counterpart of the JAX package's ``models/online.py``. The cache is padded
to a fixed ``capacity`` with an identity Cholesky block and zeroed α/δ,
plus a fill level ``count`` (a 0-dim integer tensor on the cache's
device). Each ``extend`` writes one block of b rows, at a start index
computed on the device, so a stream of extends and predictions needs no
host read.

Why padding is exact (not approximate): rows ≥ count of ``L`` hold the
identity, and the corresponding rows of every cross-covariance/rhs are
zero, so triangular solves return exact zeros there; α is zero-padded, so
predictions only see the active prefix.

At size on the card (f32) the cross-covariance against the cache and the
new block's gram run the fused gram kernel, and the whitening solve
against the padded factor the wide solve (batched ``tri_inv_block``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import covmat
from ..ops.precision import precise
from .gp import AbstractGP

__all__ = ["OnlineGP", "online_init", "online_extend", "online_mean_and_var"]


@dataclasses.dataclass(frozen=True)
class OnlineGP:
    """Fixed-capacity exact posterior cache (padded analogue of
    PosteriorGP's ``(α, C, x, δ)``)."""

    prior: AbstractGP
    L: torch.Tensor      # (cap, cap) lower chol; identity beyond count
    alpha: torch.Tensor  # (cap,) zero beyond count
    delta: torch.Tensor  # (cap,) zero beyond count
    x: torch.Tensor      # (cap, D) arbitrary beyond count
    count: torch.Tensor  # () integer fill level


def online_init(prior: AbstractGP, capacity: int, input_dim: int,
                dtype=torch.float32, device=None) -> OnlineGP:
    """An empty cache of ``capacity`` rows on ``device`` (the package's
    default device when None)."""
    from ..ops.distance import resolve_device

    device = resolve_device(device)
    return OnlineGP(
        prior=prior,
        L=torch.eye(capacity, dtype=dtype, device=device),
        alpha=torch.zeros((capacity,), dtype=dtype, device=device),
        delta=torch.zeros((capacity,), dtype=dtype, device=device),
        x=torch.zeros((capacity, input_dim), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
    )


def _active_mask(state: OnlineGP) -> torch.Tensor:
    cap = state.L.shape[0]
    return (torch.arange(cap, device=state.L.device) < state.count).to(state.L.dtype)


def _block_index(state: OnlineGP, b: int) -> torch.Tensor:
    """Indices ``start + [0, b)`` of the block written at ``count``, with the
    start clamped to ``[0, cap − b]`` as ``lax.dynamic_update_slice`` clamps
    it: a write past the capacity stays inside the buffers (the NaN poison
    below marks it), it never indexes out of bounds."""
    cap = state.L.shape[0]
    start = torch.clamp(state.count, 0, cap - b)
    return start + torch.arange(b, device=state.L.device)


@precise
def online_extend(state: OnlineGP, x_new: torch.Tensor, y_new: torch.Tensor,
                  noise_var) -> OnlineGP:
    """Condition on a new block of ``b`` observations.

    Exact counterpart of ``posterior(fx::FiniteGP{<:PosteriorGP}, y)``:
    block-extends the Cholesky (update_chol) and refreshes α by two
    triangular solves against the extended factor.
    """
    b = x_new.shape[0]
    dtype = state.L.dtype
    cap = state.L.shape[0]
    mask = _active_mask(state)

    # cross-covariance against the active prefix only (padded rows zeroed)
    C12 = state.prior.cov(state.x, x_new) * mask[:, None]        # (cap, b)
    C22 = state.prior.cov(x_new) + noise_var * torch.eye(b, dtype=dtype, device=x_new.device)

    # L21 = (L⁻¹ C12)': identity padding ⇒ exact zeros in padded columns
    L21 = covmat.solve_lower(state.L, C12).T                      # (b, cap)
    S = C22 - L21 @ L21.T
    L22 = covmat.cholesky_lower(S)

    # new block rows = [L21 with L22 spliced in at columns count:count+b];
    # L21 is already exactly zero in those columns (identity padding)
    idx = _block_index(state, b)
    new_rows = L21.index_copy(1, idx, L22)
    L = state.L.index_copy(0, idx, new_rows)

    delta_new = y_new - state.prior.mean(x_new)
    delta = state.delta.index_copy(0, idx, delta_new.to(dtype))
    x = state.x.index_copy(0, idx, x_new.to(state.x.dtype))
    count = state.count + b

    # capacity overflow poisons the cache with NaN instead of silently
    # clamping the write (which would overwrite valid factor rows and
    # return finite-but-wrong predictions): every later mean/var goes NaN
    nan = torch.tensor(float("nan"), dtype=dtype, device=L.device)
    L = torch.where(count > cap, nan, torch.ones_like(nan)) * L

    # refresh α against the extended factor; padded δ rows are zero so the
    # padded α rows come out exactly zero
    alpha = covmat.chol_solve(L, delta)
    return OnlineGP(state.prior, L, alpha, delta, x, count)


@precise
def online_mean_and_var(state: OnlineGP, x_test: torch.Tensor):
    """Posterior predictive mean/var from the padded cache (exact for the
    active prefix)."""
    mask = _active_mask(state)
    K_Xx = state.prior.cov(state.x, x_test) * mask[:, None]  # (cap, M)
    m = state.prior.mean(x_test) + K_Xx.T @ state.alpha
    V = covmat.solve_lower(state.L, K_Xx)
    v = state.prior.var(x_test) - torch.sum(V * V, dim=0)
    return m, torch.clamp(v, min=0.0)
