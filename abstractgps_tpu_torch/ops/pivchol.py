"""Partial pivoted Cholesky and the Woodbury preconditioner built from it.

Counterpart of the JAX package's ``ops/pivchol.py``. The rank-k pivoted
Cholesky ``L_k L_kᵀ ≈ K`` (greedy largest-residual-diagonal pivoting;
Harbrecht et al. 2012) preconditions CG on kernel systems (GPyTorch/BBMM,
arXiv:1809.11165 §3). Each of the k steps gathers one kernel column, an
N×1 cross gram below the fused gram's size gate, and applies a rank-1
downdate; the pivot is chosen on the device (no host read).
"""

from __future__ import annotations

import torch

from .blocked_chol import _peel_transforms
from .draws import as_draws

__all__ = ["pivoted_cholesky", "pivoted_cholesky_with_pivots", "woodbury_preconditioner"]


def pivoted_cholesky(kernel, x, rank: int) -> torch.Tensor:
    """Rank-``rank`` pivoted Cholesky factor ``L`` of ``K(x, x)`` (n, rank).

    Greedy pivoting on the residual diagonal (the first largest entry, as
    ``argmax`` picks it); a step whose pivot has no residual left records a
    zero column (exact rank < k).
    """
    return pivoted_cholesky_with_pivots(kernel, x, rank)[0]


def pivoted_cholesky_with_pivots(kernel, x, rank: int):
    """``(L, pivots)``: ``pivoted_cholesky``'s factor and the row it pivoted
    on at each step, (rank,) int64 on the device. The pivot order fixes the
    factor; another precision can pick others where the residual diagonal
    has near ties."""
    kernel, xt = _peel_transforms(kernel, x)
    n = xt.shape[0]
    d = kernel.diag(xt)
    L = xt.new_zeros((n, rank))
    pivots = []
    tiny = torch.finfo(d.dtype).tiny
    for i in range(rank):
        piv = torch.argmax(d).reshape(1)
        pivots.append(piv)
        col = kernel.cross(xt, xt.index_select(0, piv))[:, 0]  # (n,)
        col = col - L @ L.index_select(0, piv)[0]  # columns ≥ i are still zero
        dpiv = d.index_select(0, piv)[0]
        l = col / torch.sqrt(torch.clamp(dpiv, min=tiny))
        l = torch.where(dpiv > 0, l, torch.zeros_like(l))
        d = torch.clamp(d - l * l, min=0.0)
        L[:, i] = l
    return L, (torch.cat(pivots) if pivots else xt.new_zeros(0, dtype=torch.long))


def woodbury_preconditioner(Lk: torch.Tensor, noise_diag: torch.Tensor):
    """Solver, logdet and sampler for ``P = L_k L_kᵀ + diag(noise_diag)``.

    Returns ``(solve, logdet_P, sample)``:
    - ``solve(V)``: P⁻¹V by Woodbury, O(n·k) per apply;
    - ``logdet_P``: by the matrix determinant lemma;
    - ``sample(draws, p)``: (n, p) draws with covariance P (the probes of
      the preconditioned SLQ logdet need E[zzᵀ] = P); ``draws`` is a
      generator, a seed or a draws object (``ops.draws``), its u (k × p)
      drawn before its w (n × p).
    """
    k = Lk.shape[1]
    dinv = 1.0 / noise_diag
    DiL = Lk * dinv[:, None]  # D⁻¹ L
    M = torch.eye(k, dtype=Lk.dtype, device=Lk.device) + Lk.T @ DiL  # I + Lᵀ D⁻¹ L
    LM = torch.linalg.cholesky(M)

    def solve(V):
        vec = V.ndim == 1
        Vm = V[:, None] if vec else V
        W = DiL.T @ Vm  # (k, q)
        W = torch.linalg.solve_triangular(LM, W, upper=False)
        W = torch.linalg.solve_triangular(LM.T, W, upper=True)
        out = Vm * dinv[:, None] - DiL @ W
        return out[:, 0] if vec else out

    logdet_P = 2.0 * torch.sum(torch.log(torch.diagonal(LM))) + torch.sum(
        torch.log(noise_diag))

    def sample(draws, p):
        draws = as_draws(draws, Lk.device)
        u = draws.normal((k, p), Lk.dtype, Lk.device)
        w = draws.normal((Lk.shape[0], p), Lk.dtype, Lk.device)
        return Lk @ u + torch.sqrt(noise_diag)[:, None] * w

    return solve, logdet_P, sample
