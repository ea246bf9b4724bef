"""Matrix-free gram matvec: ``(K(x,x) + diag(σ²)) @ V`` in row panels.

Counterpart of the JAX package's ``ops/matvec.py``. The iterative (CG)
backend never materialises the N×N gram past ``max_dense_n``: each row
panel ``K[pB:(p+1)B, :]`` is built from the kernel (on the card, the fused
``gram_tile`` kernel through ``kernel.cross``) and contracted against V at
once, so memory is O(panel·N). The panel GEMMs run at IEEE f32 (never
TF32): CG's Krylov recurrence breaks under TF32 as a Cholesky does.
"""

from __future__ import annotations

import torch

from .blocked_chol import _peel_transforms
from .precision import full_f32

__all__ = ["gram_matvec", "make_gram_matvec"]

_PANEL = 1024


def _pad_rows(a: torch.Tensor, m: int) -> torch.Tensor:
    pad = (-a.shape[0]) % m
    if pad:
        a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    return a


def gram_matvec(kernel, x, noise_diag, V, *, panel: int = _PANEL):
    """``(K(x, x) + diag(noise_diag)) @ V`` without forming K.

    ``V`` is (N,) or (N, q). A Python loop over row panels of ``panel``
    rows; x, V and the noise are zero-padded to a whole number of panels,
    and the zero rows of V null out the padded columns of each panel.
    """
    kernel, xt = _peel_transforms(kernel, x)
    n = xt.shape[0]
    vec = V.ndim == 1
    Vm = V[:, None] if vec else V

    xp = _pad_rows(xt, panel)
    Vp = _pad_rows(Vm, panel)
    ndp = _pad_rows(noise_diag, panel)
    out = torch.empty_like(Vp)
    with full_f32():
        for r0 in range(0, xp.shape[0], panel):
            Kp = kernel.cross(xp[r0:r0 + panel], xp).to(Vp.dtype)  # (panel, npad)
            out[r0:r0 + panel] = Kp @ Vp + ndp[r0:r0 + panel, None] * Vp[r0:r0 + panel]
    out = out[:n]
    return out[:, 0] if vec else out


def make_gram_matvec(kernel, x, noise_diag, *, panel: int = _PANEL,
                     max_dense_n: int = 8192):
    """Closure ``V ↦ (K+Σ)V``; materialises K once when N ≤ ``max_dense_n``
    (every CG step is then one GEMM), else rebuilds the panels on every
    call (``gram_matvec``)."""
    n = x.shape[0]
    if n <= max_dense_n:
        K = kernel.gram(x)
        K = K + torch.diag(noise_diag.to(K.dtype))

        def mv_dense(V):
            with full_f32():
                return K @ V

        return mv_dense

    def mv_panel(V):
        return gram_matvec(kernel, x, noise_diag, V, panel=panel)

    return mv_panel
