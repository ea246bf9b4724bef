"""Matrix-free gram matvec: ``(K(x,x) + diag(σ²)) @ V`` without storing K.

Counterpart of the JAX package's ``ops/matvec.py``. The iterative (CG)
backend never materialises the N×N gram past ``max_dense_n``. Two routes,
chosen from what the operator is:

- an isotropic kernel under any nesting of ``ScaledKernel`` and
  ``TransformedKernel``, in f32 on the kernel path (a CUDA tensor, or a CPU
  one under ``fused_gram.set_interpret(True)``): ``gram_matvec_fused``,
  one launch of the hand-written kernel ``csrc/gram_matvec.cu`` that forms
  each K₀ entry on chip and multiplies it into V at once, with σ² (the
  product of the peeled variances) and the noise applied to the product;
  on a CPU tensor its plain twin ``gram_matvec_plain``;
- any other kernel, and f64: ``gram_matvec``, a Python loop over row panels
  ``K[pB:(p+1)B, :]`` built from the kernel (on the card through
  ``kernel.cross``, the fused ``gram_tile``) and contracted against V at
  once, so memory is O(panel·N).

Both run at IEEE f32 (never TF32): CG's Krylov recurrence breaks under TF32
as a Cholesky does.

``gram_matvec_fused`` — source note (``csrc/gram_matvec.cu``): replaces no
TPU kernel; the JAX package's matvec is a ``lax.fori_loop`` over panels.
Bound by FP32 operations (N²·(3D + 12 + 2q), bytes 4·(N·D + 2·N·q)).
Design: the column-split sweep of ``gram_sweep.cuh`` with V in the
cotangent's place; a thread keeps two rows' features and q accumulators in
registers and each K₀ entry lives in one register between the map and the
product (the map's square root by ``sqrt.approx.f32``, within 1 ulp); the
per-split partials are added in a fixed order by a small last launch that
applies σ² and the noise. No float atomics, no tensor cores.
"""

from __future__ import annotations

import torch

from ..utils.profiling import LIBRARY_CALLS
from . import cuda, fused_gram
from .blocked_chol import _peel_transforms
from .distance import as_inputs
from .precision import full_f32

__all__ = ["gram_matvec", "make_gram_matvec", "gram_matvec_fused", "gram_matvec_plain"]

_PANEL = 1024
_MV_ROWS, _MV_COLS, _MV_MAX_Q = 256, 64, 33  # csrc/gram_matvec.cu: kRows, kCols, kMaxQ
# the fused sweep's grid aims at this many CTAs (132 SMs of one H100); a
# constant, so that the split, and with it the bits, follow from the shapes
_MV_CTAS = 8 * 132


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


def _split_count(n: int, q: int, panel: int) -> int:
    """S, the column splits of the fused sweep's grid: the least count that
    gives ``_MV_CTAS`` CTAs with the ⌈n/256⌉ row blocks, at most the ⌈n/64⌉
    column tiles, and at most ``panel // q`` (q capped at a chunk's 33), so
    that the (S, n, q) partials hold no more than one panel of the loop
    would. A function of the shapes alone."""
    tiles = -(-n // _MV_COLS)
    want = -(-_MV_CTAS // -(-n // _MV_ROWS))
    return max(1, min(tiles, want, panel // min(q, _MV_MAX_Q)))


def gram_matvec_plain(x, V, family: int, params, s2, noise_diag, panel: int = _PANEL):
    """Plain version of ``gram_matvec_fused``: the panel loop over K₀ =
    ``gram_tile_plain`` with σ² and the noise applied to the product,
    ``σ²·(K₀ V) + noise ⊙ V``."""
    out = torch.empty_like(V)
    with full_f32():
        for r0 in range(0, x.shape[0], panel):
            K0 = fused_gram.gram_tile_plain(x[r0:r0 + panel], x, family, params)
            out[r0:r0 + panel] = (s2 * (K0 @ V)
                                  + noise_diag[r0:r0 + panel, None] * V[r0:r0 + panel])
    return out


def gram_matvec_fused(x: torch.Tensor, V: torch.Tensor, family: int, params: torch.Tensor,
                      s2: torch.Tensor, noise_diag: torch.Tensor,
                      panel: int = _PANEL) -> torch.Tensor:
    """``σ²·K₀(x, x)·V + noise ⊙ V`` for the isotropic map ``family``
    (``fused_gram.FAMILIES``): x (n, D), V (n, q), the noise (n,) in f32;
    ``params`` the map's hyperparameter buffer (``fused_gram._params_buffer``)
    and ``s2`` a 0-dim tensor, both on x's device. CUDA tensors launch
    ``csrc/gram_matvec.cu`` (the sweep and the in-order sum of its partials,
    per chunk of 33 columns of V); CPU tensors take ``gram_matvec_plain``."""
    if not x.is_cuda:
        return gram_matvec_plain(x, V, family, params, s2, noise_diag, panel)
    fused_gram._check_f32_cuda("gram_matvec", x, V, params, s2, noise_diag)
    n, d = x.shape
    if V.ndim != 2 or V.shape[0] != n or tuple(noise_diag.shape) != (n,) or s2.numel() != 1:
        raise ValueError(f"gram_matvec: bad shapes x {tuple(x.shape)}, V {tuple(V.shape)}, "
                         f"noise {tuple(noise_diag.shape)}")
    if family not in fused_gram.FAMILIES:
        raise ValueError(f"unknown gram family {family}")
    x, V, noise_diag = x.contiguous(), V.contiguous(), noise_diag.contiguous()
    q = V.shape[1]
    splits = _split_count(n, q, panel)
    out = torch.empty((n, q), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, n, min(q, _MV_MAX_Q)), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = cuda.library().agp_gram_matvec(
            x.data_ptr(), V.data_ptr(), params.data_ptr(), s2.data_ptr(),
            noise_diag.data_ptr(), out.data_ptr(), part.data_ptr(), n, d, q, family, splits,
            cuda.stream(x))
    cuda.check(err, "gram_matvec")
    cuda.LAUNCHES["gram_matvec"] += 1
    return out


def _peel_scaled(kernel, x):
    """``(base, x̂, variances)``: the transforms applied to x and the
    variances collected through any nesting of ``ScaledKernel`` and
    ``TransformedKernel`` (the outermost first, as their ``cross`` applies
    them)."""
    from ..kernels.base import ScaledKernel, TransformedKernel

    x, scales = as_inputs(x), []
    while True:
        if isinstance(kernel, TransformedKernel):
            x, kernel = kernel.transform(x), kernel.kernel
        elif isinstance(kernel, ScaledKernel):
            scales.append(kernel.variance)
            kernel = kernel.kernel
        else:
            return kernel, x, scales


def _fused_operator(kernel, x, noise_diag, panel: int):
    """``V ↦ σ²·K₀V + noise ⊙ V`` on the fused route, or None where the
    operator is not an isotropic kernel under scalings and transforms, in
    f32 on the kernel path. Peels once per solve: x̂, σ² and the map's
    hyperparameters are read off here, with no autograd graph (the solver
    runs under ``no_grad``)."""
    from ..kernels.stationary import IsotropicKernel

    with torch.no_grad():
        base, xt, scales = _peel_scaled(kernel, x)
        if (not isinstance(base, IsotropicKernel) or xt.dtype != torch.float32
                or noise_diag.dtype != torch.float32
                or not fused_gram._on_kernel_path(xt, noise_diag)):
            return None
        xt, nd = xt.detach().contiguous(), noise_diag.detach().contiguous()
        s2 = torch.ones((), dtype=torch.float32, device=xt.device)
        for v in scales:
            s2 = s2 * torch.as_tensor(v).detach().reshape(()).to(xt.device, torch.float32)
        buf = fused_gram._params_buffer(base._map_params(), xt.device)
    family = base.FAMILY

    def apply(V):
        LIBRARY_CALLS["cg_fused_matvec"] += 1
        vec = V.ndim == 1
        out = gram_matvec_fused(xt, V[:, None] if vec else V, family, buf, s2, nd, panel)
        return out[:, 0] if vec else out

    return apply


def make_gram_matvec(kernel, x, noise_diag, *, panel: int = _PANEL,
                     max_dense_n: int = 8192):
    """Closure ``V ↦ (K+Σ)V``; materialises K once when N ≤ ``max_dense_n``
    (every CG step is then one GEMM), else forms K on every call: through
    ``gram_matvec_fused`` where the kernel and the tensors allow it (an f32
    V; ``LIBRARY_CALLS["cg_fused_matvec"]`` counts each such call), else
    through the panel loop ``gram_matvec``."""
    n = x.shape[0]
    if n <= max_dense_n:
        K = kernel.gram(x)
        K = K + torch.diag(noise_diag.to(K.dtype))

        def mv_dense(V):
            with full_f32():
                return K @ V

        return mv_dense

    fused = _fused_operator(kernel, x, noise_diag, panel)

    def mv_panel(V):
        if fused is not None and V.dtype == torch.float32:
            return fused(V)
        return gram_matvec(kernel, x, noise_diag, V, panel=panel)

    return mv_panel
