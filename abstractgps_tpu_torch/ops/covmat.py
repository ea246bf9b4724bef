"""PSD / Cholesky utilities: the solves, Cholesky updates and quadratic forms.

Counterpart of the JAX package's ``ops/covmat.py`` (reference:
src/util/common_covmat_ops.jl:1-111). Factors are lower-triangular
(``L L' = A``, ``L = U'``):

    reference (U = chol(A).U)          here (L = chol(A), L = U')
    U' \\ X                            solve_lower(L, X)
    U \\ X                             solve_upper(L, X)
    Xt_invA_X(A, X) = (U'\\X)'(U'\\X)  V = solve_lower(L, X); V'V

At size on the card (f32) the Cholesky and the fat-RHS solves route to the
blocked kernels of ``ops.blocked_chol``, and ``Whitener`` keeps the inverse
of a fixed factor; everything else is ``torch.linalg``.
"""

from __future__ import annotations

import contextlib

import torch

from ..utils.profiling import LIBRARY_CALLS, span
from . import blocked_chol

__all__ = [
    "symmetrize",
    "add_jitter",
    "cholesky_lower",
    "substitution_solves",
    "solve_lower",
    "solve_upper",
    "can_hold_inverse",
    "Whitener",
    "chol_solve",
    "logdet_from_chol",
    "update_chol",
    "lowrank_update_chol",
    "Xt_A_X",
    "Xt_A_Y",
    "Xt_invA_X",
    "Xt_invA_Y",
    "At_A",
    "diag_At_A",
    "diag_At_B",
    "tr_At_A",
    "diag_Xt_A_X",
    "diag_Xt_A_Y",
    "diag_Xt_invA_X",
    "diag_Xt_invA_Y",
    "tr_Xt_invA_X",
    "Xtinv_A_Xinv",
]


def symmetrize(A: torch.Tensor) -> torch.Tensor:
    """``(A + A') / 2`` — the reference's ``_symmetric`` wrap."""
    return 0.5 * (A + A.T)


def add_jitter(A: torch.Tensor, jitter) -> torch.Tensor:
    """Add ``jitter`` to the diagonal of a square matrix."""
    n = A.shape[-1]
    return A + jitter * torch.eye(n, dtype=A.dtype, device=A.device)


def _cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.cholesky`` that returns NaN for a non-PSD input
    instead of raising (the failure-detection contract: NaN factor → inf
    logpdf → rejection)."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def cholesky_lower(A: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky of a symmetric PSD matrix.

    Large f32 matrices on the card go to the blocked factorization
    (``blocked_chol.pallas_cholesky``), which reads ONLY the lower
    triangle. Everything else symmetrises by averaging.
    """
    LIBRARY_CALLS["cholesky_lower"] += 1
    with span("ops.cholesky"):
        if blocked_chol.should_use_pallas(A):
            return blocked_chol.pallas_cholesky(A)
        return _cholesky_nan(symmetrize(A))


_WIDE_SOLVES = True  # scoped by substitution_solves(); not thread-local


@contextlib.contextmanager
def substitution_solves():
    """Scoped opt-out of the explicit-inverse (trtri+TRMM) wide solves:
    inside, ``solve_lower``/``solve_upper``/``chol_solve`` always use
    triangular substitution (for ill-conditioned, jitter-only factors)."""
    global _WIDE_SOLVES
    prev = _WIDE_SOLVES
    _WIDE_SOLVES = False
    try:
        yield
    finally:
        _WIDE_SOLVES = prev


def _tri_solve(L, B, transpose: bool):
    LIBRARY_CALLS["tri_solve"] += 1
    with span("ops.trsm"):
        if transpose:
            return torch.linalg.solve_triangular(L.T, B, upper=True)
        return torch.linalg.solve_triangular(L, B, upper=False)


def _inverse_path(L: torch.Tensor) -> bool:
    """The one gate of the explicit inverse ``W = L⁻¹`` (the wide solves and
    ``Whitener``): L an f32 matrix of N ≥ ``blocked_chol._MIN_N`` on the
    blocked kernels' path (``blocked_chol.should_use_pallas``), outside
    ``substitution_solves()``."""
    return _WIDE_SOLVES and blocked_chol.should_use_pallas(L)


def _wide_rhs(L: torch.Tensor, B: torch.Tensor) -> bool:
    """Whether the solves invert L for the (n, q) right-hand side B: on the
    inverse path with a FAT f32 B, q ≥ ``blocked_chol._WIDE_RHS`` (a thin
    RHS keeps substitution, where the trtri's cost dominates)."""
    return (_inverse_path(L) and B.dtype == torch.float32
            and B.shape[-1] >= blocked_chol._WIDE_RHS)


def _solve(L: torch.Tensor, B: torch.Tensor, transpose: bool) -> torch.Tensor:
    """``L⁻¹ B``, or ``L⁻ᵀ B`` with ``transpose``: the wide solve where
    ``_wide_rhs`` holds, substitution otherwise."""
    b_vec = B.ndim == 1
    Bm = B[:, None] if b_vec else B
    if _wide_rhs(L, Bm):
        wide = blocked_chol.solve_upper_wide if transpose else blocked_chol.solve_lower_wide
        X = wide(L, Bm)
    else:
        X = _tri_solve(L, Bm, transpose)
    return X[:, 0] if b_vec else X


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``L X = B`` for lower-triangular L (reference ``U' \\ B``).

    Fat right-hand sides on the card route to the trtri+GEMM path
    (``blocked_chol.solve_lower_wide``), which inverts L on every call; a
    caller whose L is fixed keeps that inverse instead (``Whitener``).
    Explicit-inverse-then-multiply is not backward stable; for noisy grams
    κ(L) stays small and the extra f32 error is ≲ 1e-4 relative. Wrap
    jitter-only factors in ``substitution_solves()``.
    """
    return _solve(L, B, transpose=False)


def solve_upper(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``L' X = B`` (reference ``U \\ B``); wide-RHS contract as for
    ``solve_lower``."""
    return _solve(L, B, transpose=True)


def can_hold_inverse(L: torch.Tensor) -> bool:
    """Whether ``Whitener(L)`` keeps ``W = L⁻¹``: on the inverse path, with
    no gradient flowing into L (W carries no adjoint back to L). Once W is
    paid for, a product with it beats substitution at every q."""
    return _inverse_path(L) and not (torch.is_grad_enabled() and L.requires_grad)


class Whitener:
    """``B ↦ L⁻¹ B`` for a fixed factor L. Where ``can_hold_inverse(L)``,
    the first call forms ``W = L⁻¹`` (``blocked_chol.lower_inverse``), which
    lives as long as this object, and every call whitens by one product with
    it; elsewhere each call is ``solve_lower(L, B)``, with its adjoint into
    L. A gradient in B flows through W either way."""

    def __init__(self, L: torch.Tensor):
        self.L = L
        self.W = None

    def __call__(self, B: torch.Tensor) -> torch.Tensor:
        if not can_hold_inverse(self.L):
            return solve_lower(self.L, B)
        if self.W is None:
            # a tensor with no graph whatever mode the first call runs in (a
            # later call may differentiate through W in B)
            with torch.inference_mode(False), torch.no_grad():
                LIBRARY_CALLS["wide_inverse"] += 1
                with span("ops.wide_solve.inverse"):
                    self.W = blocked_chol.lower_inverse(self.L)
        LIBRARY_CALLS["whiten_cached"] += 1
        with span("ops.whiten"):
            return blocked_chol.tri_mm(self.W, B)


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``A X = B`` given ``L = chol(A)`` (reference ``C \\ B``). A fat
    RHS on the card shares ONE triangular inverse between both solves."""
    if B.ndim == 2 and _wide_rhs(L, B):
        return blocked_chol.chol_solve_wide(L, B)
    return solve_upper(L, solve_lower(L, B))


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """``logdet(A)`` from its Cholesky factor: ``2 sum(log(diag L))``."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def update_chol(L11: torch.Tensor, C12: torch.Tensor, C22: torch.Tensor) -> torch.Tensor:
    """Block-extend a Cholesky factor without refactorising:
    ``L21 = (L11 \\ C12)'``, ``L22 = chol(C22 − L21 L21')``
    (reference update_chol, src/util/common_covmat_ops.jl:38-42)."""
    L21 = solve_lower(L11, C12).T
    L22 = cholesky_lower(C22 - L21 @ L21.T)
    n_old, n_new = L11.shape[0], C22.shape[0]
    top = torch.cat([L11, L11.new_zeros((n_old, n_new))], dim=1)
    bot = torch.cat([L21, L22], dim=1)
    return torch.cat([top, bot], dim=0)


def lowrank_update_chol(L: torch.Tensor, V: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Rank-k Cholesky update ``chol(L L' + V V')`` in O(m²k) by the blocked
    orthogonal panel-LQ algorithm: for each column panel, the full Q of the
    QR of ``[L_ii V_i]ᵀ`` (sign-fixed) restores triangularity of the panel
    row block; the same rotation applied to the rows below leaves a rank-k
    carry for the trailing panels."""
    if V.ndim == 1:
        V = V[:, None]
    m = L.shape[0]
    k = V.shape[1]
    b = min(block, m)
    out_cols = []
    Lcur, Vcur = L, V
    for r0 in range(0, m, b):
        bb = min(b, m - r0)
        panel = torch.cat([Lcur[:bb, r0:r0 + bb], Vcur[:bb]], dim=1)
        Q = torch.linalg.qr(panel.T, mode="complete")[0]
        rot = panel @ Q
        sgn = torch.sign(torch.diagonal(rot[:, :bb]))
        sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
        Q = Q * torch.cat([sgn, sgn.new_ones(k)])[None, :]
        new_diag = panel @ Q
        below = torch.cat([Lcur[bb:, r0:r0 + bb], Vcur[bb:]], dim=1) @ Q
        col = torch.cat([torch.tril(new_diag[:, :bb]), below[:, :bb]], dim=0)
        out_cols.append(torch.nn.functional.pad(col, (0, 0, r0, 0)))
        Lcur = Lcur[bb:]
        Vcur = below[:, bb:]
    return torch.cat(out_cols, dim=1)


# ---------------------------------------------------------------------------
# Quadratic forms (reference: src/util/common_covmat_ops.jl:46-111).
# `L` always denotes a lower Cholesky factor of A.
# ---------------------------------------------------------------------------


def Xt_A_X(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``X' A X`` via ``V = L' X`` → ``V' V``."""
    V = L.T @ (X[:, None] if X.ndim == 1 else X)
    out = V.T @ V
    return out[0, 0] if X.ndim == 1 else symmetrize(out)


def Xt_A_Y(X: torch.Tensor, L: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``X' A Y`` = ``(L'X)' (L'Y)``."""
    return (L.T @ X).T @ (L.T @ Y)


def Xt_invA_X(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``X' A⁻¹ X`` via whitening; a vector gives ``sum(abs2, L⁻¹ x)``."""
    V = solve_lower(L, X)
    if X.ndim == 1:
        return torch.sum(V * V)
    return symmetrize(V.T @ V)


def Xt_invA_Y(X: torch.Tensor, L: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``X' A⁻¹ Y``."""
    return solve_lower(L, X).T @ solve_lower(L, Y)


def At_A(A: torch.Tensor) -> torch.Tensor:
    """``A' A``."""
    return A.T @ A


def diag_At_A(A: torch.Tensor) -> torch.Tensor:
    """Column-wise squared norms = ``diag(A'A)``."""
    if A.ndim == 1:
        return torch.sum(A * A)[None]
    return torch.sum(A * A, dim=0)


def diag_At_B(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``diag(A'B)`` without forming A'B."""
    if A.ndim == 1:
        return torch.dot(A, B)[None]
    return torch.sum(A * B, dim=0)


def tr_At_A(A: torch.Tensor) -> torch.Tensor:
    """``tr(A'A) = ‖A‖_F²``."""
    return torch.sum(A * A)


def diag_Xt_A_X(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``diag(X' A X)``."""
    return diag_At_A(L.T @ X)


def diag_Xt_A_Y(X: torch.Tensor, L: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``diag(X' A Y)``."""
    return diag_At_B(L.T @ X, L.T @ Y)


def diag_Xt_invA_X(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``diag(X' A⁻¹ X)`` — the posterior-variance hot path."""
    return diag_At_A(solve_lower(L, X))


def diag_Xt_invA_Y(X: torch.Tensor, L: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``diag(X' A⁻¹ Y)``."""
    return diag_At_B(solve_lower(L, X), solve_lower(L, Y))


def tr_Xt_invA_X(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``tr(X' A⁻¹ X)`` — the Mahalanobis hot path."""
    return tr_At_A(solve_lower(L, X))


def Xtinv_A_Xinv(L_A: torch.Tensor, L_X: torch.Tensor) -> torch.Tensor:
    """``X⁻¹ A X⁻'`` for Cholesky-factored A and X, as the JAX package
    computes it: ``C = (L_A')⁻¹ L_X⁻¹ L_A``, ``Symmetric(C C')``."""
    C = solve_upper(L_A, solve_lower(L_X, L_A))
    return symmetrize(C @ C.T)
