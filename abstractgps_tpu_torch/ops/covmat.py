"""PSD / Cholesky utilities: the solves, Cholesky updates and quadratic forms.

Counterpart of the JAX package's ``ops/covmat.py`` (reference:
src/util/common_covmat_ops.jl:1-111). Factors are lower-triangular
(``L L' = A``, ``L = U'``):

    reference (U = chol(A).U)          here (L = chol(A), L = U')
    U' \\ X                            solve_lower(L, X)
    U \\ X                             solve_upper(L, X)
    Xt_invA_X(A, X) = (U'\\X)'(U'\\X)  V = solve_lower(L, X); V'V

At size on the card (f32) the Cholesky and the fat-RHS solves route to the
blocked kernels of ``ops.blocked_chol``; everything else is
``torch.linalg``.
"""

from __future__ import annotations

import contextlib

import torch

from ..utils.profiling import LIBRARY_CALLS, span

__all__ = [
    "symmetrize",
    "add_jitter",
    "cholesky_lower",
    "substitution_solves",
    "solve_lower",
    "solve_upper",
    "can_hold_inverse",
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
    from . import blocked_chol

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


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``L X = B`` for lower-triangular L (reference ``U' \\ B``).

    Fat right-hand sides on the card route to the trtri+GEMM path
    (``blocked_chol.solve_lower_wide``), which inverts L on every call; the
    exact posterior, whose L is fixed, keeps that inverse instead
    (``can_hold_inverse``). Explicit-inverse-then-multiply is not backward
    stable; for noisy grams κ(L) stays small and the extra f32 error is
    ≲ 1e-4 relative. Wrap jitter-only factors in ``substitution_solves()``.
    """
    from . import blocked_chol

    b_vec = B.ndim == 1
    Bm = B[:, None] if b_vec else B
    if _WIDE_SOLVES and blocked_chol.should_use_wide_solve(L, Bm):
        X = blocked_chol.solve_lower_wide(L, Bm)
    else:
        X = _tri_solve(L, Bm, transpose=False)
    return X[:, 0] if b_vec else X


def solve_upper(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``L' X = B`` (reference ``U \\ B``); wide-RHS contract as for
    ``solve_lower``."""
    from . import blocked_chol

    b_vec = B.ndim == 1
    Bm = B[:, None] if b_vec else B
    if _WIDE_SOLVES and blocked_chol.should_use_wide_solve(L, Bm):
        X = blocked_chol.solve_upper_wide(L, Bm)
    else:
        X = _tri_solve(L, Bm, transpose=True)
    return X[:, 0] if b_vec else X


def can_hold_inverse(L: torch.Tensor) -> bool:
    """Whether a caller may keep ``W = L⁻¹`` of a fixed factor and whiten
    by products with it (``blocked_chol.whiten_held``) in place of
    ``solve_lower``: ``blocked_chol.should_hold_inverse(L)``, outside
    ``substitution_solves()``."""
    from . import blocked_chol

    return _WIDE_SOLVES and blocked_chol.should_hold_inverse(L)


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``A X = B`` given ``L = chol(A)`` (reference ``C \\ B``). A fat
    RHS on the card shares ONE triangular inverse between both solves."""
    from . import blocked_chol

    if _WIDE_SOLVES and B.ndim == 2 and blocked_chol.should_use_wide_solve(L, B):
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
