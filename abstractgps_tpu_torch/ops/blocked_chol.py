"""Blocked Cholesky, fused gram→Cholesky→logpdf, and the wide triangular
solves (forward).

Counterpart of the JAX package's ``ops/pallas_chol.py``. The factorization
is the same two-level left-looking sweep: outer slabs of width ``_OUTER``
are updated against all finished columns with one GEMM per finished slab;
inside a slab, the diagonal ``_OUTER``² block goes to ``slab_factor`` (a
ragged tail slab goes block by block through ``chol_inv_block``), and the
rows below are solved against the block inverses with GEMMs. The gram
panels can be BUILT inside the sweep (``cholesky_gram``), so K never
exists in device memory, and the whitening solve of the logpdf rides the
sweep (``gram_logpdf_core``). One triangular inverse, ``lower_inverse``
(its diagonal blocks from one batched ``tri_inv_block`` launch), serves the
logpdf backward, the wide solves (trtri + TRMM) and ``covmat.Whitener``,
which keeps it for a fixed factor; ``tri_mm`` is the one rule for
multiplying by it.

The four hand-written kernels of this module (``csrc/``) each have a plain
torch version beside them: a CUDA tensor launches the kernel, a CPU tensor
takes the plain version. ``set_enabled(False)`` closes the gates, so every
tensor takes the library path instead. The panel GEMMs, doubling merges
and TRMMs are large products outside any kernel, left to ``torch.matmul``
at IEEE f32 (never TF32), as the JAX package left them to XLA.

Source notes (TPU kernel → this port, bound on the H100, design):

``chol_inv_block`` ← ``abstractgps_tpu/ops/pallas_chol.py:179``
  (``_chol_inv_block``, body :77-175). Latency-bound: a chain of B column
  steps on a 128² block. One CTA runs the block routine of
  ``csrc/block_routines.cuh``: the factor and the inverse (exact blocked
  forward substitution, no Newton polish needed) in one pass of 8-column
  group steps.
``slab_factor`` ← ``abstractgps_tpu/ops/pallas_chol.py:339``
  (``_slab_factor``, ``_slab_body`` :298). Operation-bound in principle
  (W³/3 flops at W = 1024), but a 4 MB slab does not fit one SM's shared
  memory as it fit VMEM: the slab stays in device memory (L2-resident),
  and per diagonal block a short fixed launch sequence runs the block
  routine above, then the slab-local panel L21 = P·W_kᵀ and the trailing
  update S22 −= L21·L21ᵀ as hand-written tiled FP32 kernels.
``tri_inv_block`` ← ``abstractgps_tpu/ops/pallas_chol.py:405``
  (``_tri_inv_block``, body :368-401). Latency-bound per block; batched
  with one CTA per diagonal block, read in place through strides. Each
  CTA runs the block routine above with L given: the inverse's group
  steps alone, the next column group of L loaded while a step runs.
``chol_block`` ← ``abstractgps_tpu/ops/pallas_chol.py:455``
  (``_chol_block``, body :425-451). The factor half of the block routine,
  one CTA. No path of either package calls it.

Layouts: ``slab_factor`` returns the plain-lower slab factor L (the TPU
kernel returned Lᵀ, a store-layout choice) and the (W/B, B, B) inverses of
its diagonal blocks; ``chol_inv_block`` returns (L, L⁻¹), plain lower;
``chol_block`` returns L, plain lower as the TPU kernel did.

Backward passes (``torch.autograd.Function``s, the JAX package's
``custom_vjp``/``custom_jvp`` rules written as reverse rules):

- ``pallas_cholesky`` and ``cholesky_gram``: Murray's pullback
  Ā = sym(L⁻ᵀ Φ(Lᵀ L̄) L⁻¹), its two solves as triangular substitutions
  (``torch.linalg.solve_triangular``), as the reference does them; ``cholesky_gram`` then
  takes the VJP of K(x, x) + diag(noise) through ``kernel.gram`` (the
  gram VJP kernel ``fused_gram.gram_bwd`` at size).
- ``gram_logpdf_core``: ∂logpdf/∂K = ½(ααᵀ − K⁻¹), with tril(K⁻¹) from the
  trtri + lauum and α = L⁻ᵀz from the trtri's L⁻¹ (one thin GEMM); for an
  isotropic base kernel under a Scale/Transform chain the contraction is
  the kernel ``fused_gram.logpdf_contraction``, other kernels go through
  autograd of ⟨C, K⟩.
- the wide solves (one Function, three modes): the triangular-solve
  adjoints over the L⁻¹ that their forward computed.

Each backward takes the kernel's hyperparameter tensors
(``kernels.base.hyperparameters``) as inputs, so gradients reach the
caller's tensors as well as the kernel's ``nn.Parameter``s.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils.profiling import LIBRARY_CALLS, span
from . import cuda
from .precision import full_f32

_INTERPRET = False  # tests: route CPU f32 tensors through the plain versions
_ENABLED = True     # False: every tensor takes the library path (torch.linalg)
_MIN_N = 1024       # below this torch.linalg is already fine
_BLOCK = 128        # diagonal block width
_OUTER = 1024       # outer slab width of the two-level sweep
_WIDE_RHS = 256     # the trtri amortizes over this many RHS columns
_TRMM_SPLIT = 2048  # split triangular products from this many rows ...
_TRMM_RHS = 512     # ... and this many right-hand-side columns; below, one GEMM


def set_enabled(flag: bool) -> None:
    """``False`` turns this module's kernel paths off: the gates below
    return False, so a card tensor takes the library path (``torch.linalg``
    and cuBLAS), as a CPU f64 tensor does. The choice is made before any
    kernel is tried; it is no fallback."""
    global _ENABLED
    _ENABLED = flag


def set_interpret(flag: bool) -> None:
    global _INTERPRET
    _INTERPRET = flag


def _on_kernel_path(t: torch.Tensor) -> bool:
    return _ENABLED and (_INTERPRET or t.is_cuda)


def should_use_pallas(A: torch.Tensor) -> bool:
    """Gate for the blocked kernels on one matrix: f32 on the card,
    N ≥ _MIN_N. ``covmat`` reads it for ``pallas_cholesky`` and, outside
    ``substitution_solves()``, for ``lower_inverse`` of a factor."""
    if not _on_kernel_path(A):
        return False
    if A.ndim != 2 or A.dtype != torch.float32:
        return False
    return A.shape[-1] >= _MIN_N


def should_use_fused_gram(x: torch.Tensor, noise_diag: torch.Tensor) -> bool:
    """Gate for ``cholesky_gram`` / ``gram_logpdf_core`` (same policy)."""
    if not _on_kernel_path(x):
        return False
    if x.dtype != torch.float32 or noise_diag.dtype != torch.float32:
        return False
    return x.shape[0] >= _MIN_N


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Panel GEMM at IEEE f32 whatever the precision policy (TF32 would
    corrupt the factorization)."""
    LIBRARY_CALLS["mm"] += 1
    with full_f32():
        return a @ b


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def _f32_rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` as the kernels read it: an f32 matrix with unit inner stride
    (a column-major factor, as ``torch.linalg.cholesky`` returns on the
    card, is copied to row-major)."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} takes f32, got {t.dtype}")
    if t.ndim != 2:
        raise ValueError(f"{name} takes a matrix, got shape {tuple(t.shape)}")
    return t if t.stride(-1) == 1 else t.contiguous()


def _invert_lower_plain(L: torch.Tensor) -> torch.Tensor:
    """L⁻¹ of (a batch of) lower-triangular blocks by the kernels' forward
    substitution; reads the lower triangle only."""
    B = L.shape[-1]
    W = torch.eye(B, dtype=L.dtype, device=L.device).expand(L.shape).clone()
    for j in range(B):
        W[..., j, :j + 1] /= L[..., j, j, None]
        W[..., j + 1:, :j + 1] -= L[..., j + 1:, j, None] * W[..., j, None, :j + 1]
    return W


def chol_block_plain(A: torch.Tensor) -> torch.Tensor:
    """Plain version of ``chol_block``: the plain-lower factor of one SPD
    block by right-looking column steps; lower triangle read, upper
    triangle of the result zero; a negative pivot gives NaN."""
    M = torch.tril(A)
    for j in range(A.shape[0]):
        d = torch.sqrt(M[j, j])
        col = M[j + 1:, j] / d
        M[j, j] = d
        M[j + 1:, j] = col
        M[j + 1:, j + 1:] -= col[:, None] * col[None, :]
    return torch.tril(M)


def chol_inv_block_plain(A: torch.Tensor):
    """Plain version of ``chol_inv_block``: (L, L⁻¹) of one SPD block, the
    factor by ``chol_block_plain``, the inverse by forward substitution."""
    L = chol_block_plain(A)
    return L, _invert_lower_plain(L)


def _diag_block(A: torch.Tensor, name: str) -> torch.Tensor:
    """``A`` as the block kernels take it: a square f32 block of edge
    B ≤ 128 with B a multiple of 8 (the kernels' column-group width)."""
    A = _f32_rows(A, name)
    B = A.shape[0]
    if A.shape[1] != B or B > 128 or B % 8:
        raise ValueError(f"{name}: bad block shape {tuple(A.shape)} "
                         "(square, edge ≤ 128 and a multiple of 8)")
    return A


def chol_block(A: torch.Tensor) -> torch.Tensor:
    """Plain-lower Cholesky factor of one (B, B) SPD block (B ≤ 128, a
    multiple of 8 on the card), lower triangle read (rows may be strided),
    upper triangle zero; a non-PSD block gives NaN. CUDA: one launch of
    ``csrc/chol_block.cu``."""
    if not A.is_cuda:
        return chol_block_plain(A)
    A = _diag_block(A, "chol_block")
    B = A.shape[0]
    L = torch.empty((B, B), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        err = cuda.library().agp_chol_block(A.data_ptr(), A.stride(0), L.data_ptr(), B,
                                            cuda.stream(A))
    cuda.check(err, "chol_block")
    cuda.LAUNCHES["chol_block"] += 1
    return L


def chol_inv_block(A: torch.Tensor):
    """(L, L⁻¹) of one (B, B) SPD block (B ≤ 128, a multiple of 8 on the
    card), lower triangle read (rows may be strided). CUDA: one launch of
    ``csrc/chol_inv_block.cu``."""
    if not A.is_cuda:
        return chol_inv_block_plain(A)
    A = _diag_block(A, "chol_inv_block")
    B = A.shape[0]
    L = torch.empty((B, B), dtype=torch.float32, device=A.device)
    W = torch.empty((B, B), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        err = cuda.library().agp_chol_inv_block(
            A.data_ptr(), A.stride(0), L.data_ptr(), W.data_ptr(), B, cuda.stream(A))
    cuda.check(err, "chol_inv_block")
    cuda.LAUNCHES["chol_inv_block"] += 1
    return L, W


def slab_factor_plain(S: torch.Tensor, block: int):
    """Plain version of ``slab_factor``: the same block steps with torch
    products."""
    W = S.shape[0]
    work = S.clone()
    L = torch.zeros_like(S)
    Winv = S.new_empty((W // block, block, block))
    for k in range(W // block):
        r0 = k * block
        Lkk, Wk = chol_inv_block_plain(work[r0:r0 + block, r0:r0 + block])
        L[r0:r0 + block, r0:r0 + block] = Lkk
        Winv[k] = Wk
        if r0 + block < W:
            L21 = _mm(work[r0 + block:, r0:r0 + block], Wk.T)
            L[r0 + block:, r0:r0 + block] = L21
            work[r0 + block:, r0 + block:] -= _mm(L21, L21.T)
    return L, Winv


def slab_factor(S: torch.Tensor, block: int):
    """(plain-lower L, (W/B, B, B) diagonal-block inverses) of one (W, W)
    SPD slab, lower triangle read. CUDA: ``csrc/slab_factor.cu`` (one call,
    a fixed sequence of launches on the current stream)."""
    if not S.is_cuda:
        return slab_factor_plain(S, block)
    S = _f32_rows(S, "slab_factor").contiguous()
    W = S.shape[0]
    if S.shape[1] != W or W % block or block > 128 or block % 8:
        raise ValueError(f"slab_factor: bad slab {tuple(S.shape)} / block {block}")
    L = torch.empty_like(S)
    Winv = S.new_empty((W // block, block, block))
    work = torch.empty_like(S)
    with torch.cuda.device(S.device):
        err = cuda.library().agp_slab_factor(
            S.data_ptr(), L.data_ptr(), Winv.data_ptr(), work.data_ptr(), W, block,
            cuda.stream(S))
    cuda.check(err, "slab_factor")
    cuda.LAUNCHES["slab_factor"] += 1
    return L, Winv


def tri_inv_block_plain(L: torch.Tensor, block: int) -> torch.Tensor:
    """Plain version of ``tri_inv_block``."""
    nb = L.shape[0] // block
    blocks = torch.stack([L[i * block:(i + 1) * block, i * block:(i + 1) * block]
                          for i in range(nb)])
    return _invert_lower_plain(blocks)


def tri_inv_block(L: torch.Tensor, block: int) -> torch.Tensor:
    """(nb, B, B) inverses of the nb = n/B lower-triangular diagonal blocks
    of the (n, n) matrix L (lower triangles read; rows may be strided; B a
    multiple of 8 on the card). CUDA: one batched launch of
    ``csrc/tri_inv_block.cu``."""
    if not L.is_cuda:
        return tri_inv_block_plain(L, block)
    L = _f32_rows(L, "tri_inv_block")
    n = L.shape[0]
    if L.shape[1] != n or n % block or block > 128 or block % 8:
        raise ValueError(f"tri_inv_block: bad matrix {tuple(L.shape)} / block {block}")
    nb = n // block
    ld = L.stride(0)
    out = L.new_empty((nb, block, block))
    with torch.cuda.device(L.device):
        err = cuda.library().agp_tri_inv_block(
            L.data_ptr(), ld, block * ld + block, nb, block, out.data_ptr(),
            cuda.stream(L))
    cuda.check(err, "tri_inv_block")
    cuda.LAUNCHES["tri_inv_block"] += 1
    return out


# ---------------------------------------------------------------------------
# Blocked left-looking sweep
# ---------------------------------------------------------------------------


def _sweep_slabs(npad: int, block: int, panel_fn, dtype, rhs=None):
    """The two-level sweep. Returns the factored outer slabs as a list
    ``[(r0_j, Sf_j)]`` (Sf_j is (npad − r0_j, w_j)) and, with ``rhs``
    (npad, q), the blocks of ``Z = L⁻¹ rhs`` computed while sweeping.
    Spans of an outer slab: ``ops.sweep.panel`` (the panel), ``.update``
    (against the finished slabs), ``.factor`` (the diagonal block, then the
    rows below it), ``.solve`` (the right-hand side within the slab, then
    below it), in the order the work is launched."""
    with span("ops.sweep"):
        return _sweep(npad, block, panel_fn, dtype, rhs)


def _sweep(npad: int, block: int, panel_fn, dtype, rhs):
    slabs = []
    R = None if rhs is None else rhs.clone()
    zs = []
    r0 = 0
    while r0 < npad:
        w = min(_OUTER, npad - r0)
        with span("ops.sweep.panel"):
            S = panel_fn(r0, w)  # (npad - r0, w)
        with span("ops.sweep.update"):
            for b_j, Sf_j in slabs:
                o = r0 - b_j
                S = S - _mm(Sf_j[o:], Sf_j[o:o + w].T)
        rows = npad - r0
        Sf = S.new_zeros((rows, w), dtype=dtype)
        if w == _OUTER:
            with span("ops.sweep.factor"):
                L_slab, Ws = slab_factor(S[:w].contiguous(), block)
                Sf[:w] = L_slab
            zs_slab = []
            if R is not None:
                with span("ops.sweep.solve"):
                    # blocked forward substitution within the slab, reusing
                    # the slab's diagonal-block inverses
                    for j in range(w // block):
                        jb = j * block
                        rj = R[r0 + jb:r0 + jb + block]
                        if j:
                            rj = rj - _mm(L_slab[jb:jb + block, :jb], torch.cat(zs_slab))
                        zs_slab.append(_mm(Ws[j], rj))
                    zs.extend(zs_slab)
            if rows > w:
                with span("ops.sweep.factor"):  # the rows below the diagonal block
                    for j in range(w // block):
                        jb = j * block
                        P = S[w:, jb:jb + block]
                        if j:
                            P = P - _mm(Sf[w:, :jb], L_slab[jb:jb + block, :jb].T)
                        Sf[w:, jb:jb + block] = _mm(P, Ws[j].T)
            if R is not None and r0 + w < npad:
                with span("ops.sweep.solve"):
                    R[r0 + w:] -= _mm(Sf[w:], torch.cat(zs_slab))
            slabs.append((r0, Sf))
            r0 += w
            continue
        with span("ops.sweep.factor"):  # a ragged slab, block by block, rhs and all
            for rr in range(0, w, block):
                P = S[rr:, rr:rr + block]
                if rr:
                    P = P - _mm(Sf[rr:, :rr], Sf[rr:rr + block, :rr].T)
                Lkk, W = chol_inv_block(P[:block])
                Sf[rr:rr + block, rr:rr + block] = Lkk
                if rr + block < rows:
                    Sf[rr + block:, rr:rr + block] = _mm(P[block:], W.T)
                if R is not None:
                    g0 = r0 + rr
                    z_k = _mm(W, R[g0:g0 + block])  # L_kk⁻¹ · rhs panel
                    zs.append(z_k)
                    if g0 + block < npad:
                        R[g0 + block:] -= _mm(Sf[rr + block:, rr:rr + block], z_k)
        slabs.append((r0, Sf))
        r0 += w
    return slabs, zs


def _assemble_slabs(npad: int, slabs, dtype, device) -> torch.Tensor:
    """Materialise the N×N lower factor from the slab list."""
    L = torch.zeros((npad, npad), dtype=dtype, device=device)
    for r0, Sf in slabs:
        L[r0:, r0:r0 + Sf.shape[1]] = Sf
    return L


def _slabs_logdet(slabs) -> torch.Tensor:
    """Σ log diag(L) read directly off the slab diagonals."""
    return sum(torch.sum(torch.log(torch.diagonal(Sf[:Sf.shape[1]])))
               for _, Sf in slabs)


def _pad_identity(A: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad a square matrix with an identity trailing corner (SPD, log 1 = 0)."""
    n = A.shape[-1]
    A = F.pad(A, (0, pad, 0, pad))
    A.diagonal()[n:] = 1.0
    return A


def _blocked_cholesky_impl(A: torch.Tensor, block: int) -> torch.Tensor:
    """Left-looking blocked Cholesky; reads ONLY the lower triangle of A."""
    n = A.shape[-1]
    pad = (-n) % block
    if pad:
        A = _pad_identity(A, pad)
    slabs, _ = _sweep_slabs(n + pad, block, lambda r0, w: A[r0:, r0:r0 + w], A.dtype)
    L = _assemble_slabs(n + pad, slabs, A.dtype, A.device)
    return L[:n, :n] if pad else L


def _chol_pullback(L: torch.Tensor, Lbar: torch.Tensor) -> torch.Tensor:
    """Ā = sym(L⁻ᵀ Φ(Lᵀ L̄) L⁻¹), Φ = strict lower + ½·diag (Murray 2016):
    the reverse rule of L = chol(A) (the JAX package's ``custom_jvp`` at
    ``pallas_chol.py:674`` and ``_cholesky_gram_bwd`` at :794). As there,
    the two solves are triangular substitutions, Y = L⁻ᵀP and
    Ā = (L⁻ᵀYᵀ)ᵀ, at IEEE f32: an explicit L⁻¹ loses ~10× in accuracy."""
    M = _mm(L.T, torch.tril(Lbar))
    P = torch.tril(M, -1) + 0.5 * torch.diag(torch.diagonal(M))
    with full_f32():
        Y = torch.linalg.solve_triangular(L.T, P, upper=True)
        Abar = torch.linalg.solve_triangular(L.T, Y.T, upper=True).T
    return 0.5 * (Abar + Abar.T)


class _PallasCholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A):
        L = _blocked_cholesky_impl(A, _BLOCK)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        return _chol_pullback(L, Lbar)


def pallas_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Blocked Cholesky of a symmetric PSD matrix (lower factor; lower
    triangle read). Non-PSD inputs propagate NaN."""
    return _PallasCholesky.apply(A)


# ---------------------------------------------------------------------------
# Fused gram → Cholesky: K + diag(σ²) is never materialised
# ---------------------------------------------------------------------------


def _peel_transforms(kernel, x):
    """Apply input transforms once up front (they are pointwise in the
    inputs), so the per-panel cross-gram does not re-run them."""
    from ..kernels.base import TransformedKernel
    from .distance import as_inputs

    x = as_inputs(x)
    while isinstance(kernel, TransformedKernel):
        x = kernel.transform(x)
        kernel = kernel.kernel
    return kernel, x


def _gram_sweep_slabs(kernel, x, noise_diag, block, rhs=None):
    """Factored slabs of ``chol(K(x,x)+diag(noise))`` with the gram panels
    BUILT inside the sweep. Returns ``(slabs, zs, n, npad)``."""
    kernel, x = _peel_transforms(kernel, x)
    n = x.shape[0]
    pad = (-n) % block
    npad = n + pad
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        noise_diag = F.pad(noise_diag, (0, pad))
        if rhs is not None:
            rhs = F.pad(rhs, (0, 0, 0, pad))

    def panel_fn(r0, w):
        P = kernel.cross(x[r0:], x[r0:r0 + w]).to(torch.float32).contiguous()
        P[:w].diagonal().add_(noise_diag[r0:r0 + w])
        lo = max(n - r0, 0)  # first padded local row/column
        if lo < npad - r0:
            # padded rows/cols → identity block (log 1 = 0, zero fill-in)
            P[lo:] = 0.0
            if lo < w:
                P[:, lo:] = 0.0
                P[:w].diagonal()[lo:] = 1.0
        return P

    slabs, zs = _sweep_slabs(npad, block, panel_fn, torch.float32, rhs)
    return slabs, zs, n, npad


def _cholesky_gram_impl(kernel, x, noise_diag, block, rhs=None):
    """``chol(K(x,x)+diag(noise))`` with the panels built in the sweep; with
    ``rhs`` (n, q) also returns ``L⁻¹ rhs``."""
    slabs, zs, n, npad = _gram_sweep_slabs(kernel, x, noise_diag, block, rhs)
    L = _assemble_slabs(npad, slabs, torch.float32, x.device)[:n, :n]
    if rhs is not None:
        return L, torch.cat(zs)[:n]
    return L


def _param_grads(params, bars: dict):
    """The Function's gradients for its hyperparameter inputs, from a dict
    id(tensor) → bar (None where nothing flowed)."""
    out = []
    for p in params:
        b = bars.get(id(p))
        out.append(None if b is None else b.to(dtype=p.dtype, device=p.device).reshape(p.shape))
    return out


def _gram_vjp(kernel, x, params, Kbar):
    """(x̄, {id(param): bar}) of ⟨K̄, kernel.gram(x)⟩ by autograd through the
    kernel's own gram (the gram VJP kernel at size), stopping at the
    hyperparameters (``leaf_hyperparameters``)."""
    from ..kernels.base import leaf_hyperparameters

    with torch.enable_grad(), leaf_hyperparameters(kernel) as alias:
        x_ = x.detach().requires_grad_()
        K = kernel.gram(x_)
        wrt = [p for p in params if p.requires_grad]
        grads = torch.autograd.grad(K, [x_, *[alias.get(id(p), p) for p in wrt]],
                                    grad_outputs=Kbar.to(K.dtype), allow_unused=True)
    return grads[0], {id(p): g for p, g in zip(wrt, grads[1:]) if g is not None}


class _CholeskyGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, x, noise_diag, *params):
        L = _cholesky_gram_impl(kernel, x, noise_diag, _BLOCK)
        ctx.kernel = kernel
        ctx.save_for_backward(x, L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        from ..kernels.base import hyperparameters

        x, L = ctx.saved_tensors
        params = hyperparameters(ctx.kernel)
        Abar = _chol_pullback(L, Lbar)
        xbar, bars = _gram_vjp(ctx.kernel, x, params, Abar)
        return (None, xbar, torch.diagonal(Abar).clone(), *_param_grads(params, bars))


def cholesky_gram(kernel, x, noise_diag):
    """``chol(K(x, x) + diag(noise_diag))`` without materialising K;
    differentiable in x, the noise and the kernel's hyperparameters."""
    from ..kernels.base import hyperparameters

    return _CholeskyGram.apply(kernel, x, noise_diag, *hyperparameters(kernel))


# ---------------------------------------------------------------------------
# Fused gram → Cholesky → logpdf
# ---------------------------------------------------------------------------


def _fused_logpdf(kernel, x, noise_diag, delta):
    """(logpdf, (slabs, zs, n, npad)): the whitening solve and logdet ride
    the sweep; the N×N factor is never assembled (a backward assembles it
    from the slabs)."""
    vec = delta.ndim == 1
    D = (delta[:, None] if vec else delta).to(torch.float32)
    slabs, zs, n, npad = _gram_sweep_slabs(kernel, x, noise_diag, _BLOCK, rhs=D)
    logdet = 2.0 * _slabs_logdet(slabs)
    z = torch.cat(zs)
    quad = torch.sum(z * z, dim=0)
    out = -0.5 * (n * math.log(2.0 * math.pi) + logdet + quad)
    return (out[0] if vec else out), (slabs, zs, n, npad)


class _GramLogpdfCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, x, noise_diag, delta, *params):
        out, (slabs, zs, n, npad) = _fused_logpdf(kernel, x, noise_diag, delta)
        # the backward assembles the factor from the slabs, which are kept
        # only when a backward can run (padded rows and columns are the
        # identity, padded z rows exactly 0); α = L⁻ᵀz is deferred to the
        # backward, which gets L⁻¹ from the potri's trtri
        ctx.kernel, ctx.vec, ctx.n, ctx.npad = kernel, delta.ndim == 1, n, npad
        ctx.offsets = [r0 for r0, _ in slabs]
        ctx.save_for_backward(x, noise_diag, torch.cat(zs), *(Sf for _, Sf in slabs))
        return out

    @staticmethod
    def backward(ctx, gbar):
        with span("ops.logpdf_backward"):
            return _GramLogpdfCore._backward(ctx, gbar)

    @staticmethod
    def _backward(ctx, gbar):
        from ..kernels.base import hyperparameters

        x, noise_diag, zp, *Sfs = ctx.saved_tensors
        kernel, n = ctx.kernel, ctx.n
        with span("ops.logpdf_backward.assemble"):
            Lp = _assemble_slabs(ctx.npad, list(zip(ctx.offsets, Sfs)), torch.float32,
                                 x.device)
        params = hyperparameters(kernel)
        g = (gbar.reshape(1) if ctx.vec else gbar).to(torch.float32)
        with span("ops.logpdf_backward.trtri"):
            W = lower_inverse(Lp)
        with span("ops.logpdf_backward.lauum"):
            T = _lauum(W)
        alpha = _mm(W.T, zp)[:n]  # α = L⁻ᵀ z = (K+Σ)⁻¹ δ
        T = T[:n, :n]             # tril(K⁻¹)
        gsum = torch.sum(g)
        with span("ops.logpdf_backward.contraction"):
            fused = _try_fused_contraction(kernel, x, alpha, g, T, gsum, params)
            if fused is not None:
                xbar, bars, ndbar = fused
            else:
                # ⟨Ā, K⟩ with Ā = ½(Σ_j ḡ_j α_j α_jᵀ − ḡΣ K⁻¹) symmetric,
                # folded onto the lower triangle (T holds only tril(K⁻¹))
                A_low = 0.5 * (_mm(alpha * g[None, :], alpha.T) - gsum * T)
                C = torch.tril(A_low, -1) * 2.0 + torch.diag(torch.diagonal(A_low))
                xbar, bars = _gram_vjp(kernel, x, params, C)
                ndbar = torch.diagonal(C).clone()
        dbar = -(alpha * g[None, :])  # ∂/∂δ_j = −ḡ_j α_j
        dbar = dbar[:, 0] if ctx.vec else dbar
        return (None, xbar, ndbar.to(noise_diag.dtype), dbar, *_param_grads(params, bars))


def gram_logpdf_core(kernel, x, noise_diag, delta):
    """``-0.5 (n log2π + logdet(K+Σ) + δᵀ(K+Σ)⁻¹δ)`` per column of δ,
    without materialising K. ``delta`` is (n,) or (n, q); returns a scalar
    or (q,). Differentiable in x, the noise, δ and the kernel's
    hyperparameters."""
    from ..kernels.base import hyperparameters

    return _GramLogpdfCore.apply(kernel, x, noise_diag, delta, *hyperparameters(kernel))


def _try_fused_contraction(kernel, x, alpha, g, T, gsum, params):
    """The logpdf backward's contraction through the single-sweep kernel
    ``fused_gram.logpdf_contraction`` when the kernel peels to a
    Scale/Transform chain over an isotropic base: ``(x̄, bars, noise bar)``,
    or None (the generic autograd fallback: sums, products, periodic, ...).
    The peel itself is differentiated by autograd, with the kernel's bars
    as ``grad_outputs``, so any transform stack keeps exact cotangents."""
    from ..kernels.base import ScaledKernel, TransformedKernel, leaf_hyperparameters
    from ..kernels.stationary import IsotropicKernel
    from . import fused_gram
    from .distance import as_inputs

    base = kernel
    while isinstance(base, (ScaledKernel, TransformedKernel)):
        base = base.kernel
    if not isinstance(base, IsotropicKernel):
        return None
    if not fused_gram._on_kernel_path(T):
        return None
    if T.dtype != torch.float32 or T.shape[0] < _MIN_N:
        return None

    map_params = base._map_params()
    with torch.enable_grad(), leaf_hyperparameters(kernel) as alias:
        x_ = x.detach().requires_grad_()
        s2 = torch.ones((), dtype=torch.float32, device=x.device)
        k, xp = kernel, as_inputs(x_)
        while isinstance(k, (ScaledKernel, TransformedKernel)):
            if isinstance(k, ScaledKernel):
                s2 = s2 * k.variance
            else:
                xp = k.transform(xp)
            k = k.kernel
        s2bar, pbar, xpbar = fused_gram.logpdf_contraction(
            xp.detach().to(torch.float32), s2.detach().to(torch.float32).reshape(()),
            alpha * g[None, :], alpha, gsum, T, base.FAMILY, base._map_params())
        outs, couts = [xp], [xpbar.to(xp.dtype)]
        if s2.requires_grad:
            outs.append(s2)
            couts.append(s2bar.to(s2.dtype).reshape(s2.shape))
        wrt = [p for p in params if p.requires_grad]
        grads = torch.autograd.grad(outs, [x_, *[alias.get(id(p), p) for p in wrt]],
                                    grad_outputs=couts, allow_unused=True)
    bars = {id(p): gr for p, gr in zip(wrt, grads[1:]) if gr is not None}
    for p in map_params:  # the base map's hyperparameter takes p̄ directly
        bars[id(p)] = pbar
    ndbar = 0.5 * (torch.sum(alpha * alpha * g[None, :], dim=1) - gsum * torch.diagonal(T))
    return grads[0], bars, ndbar


def _logpdf_from_chol(L, delta):
    n = L.shape[0]
    vec = delta.ndim == 1
    D = delta[:, None] if vec else delta
    z = torch.linalg.solve_triangular(L, D, upper=False)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    quad = torch.sum(z * z, dim=0)
    out = -0.5 * (n * math.log(2.0 * math.pi) + logdet + quad)
    return out[0] if vec else out


# ---------------------------------------------------------------------------
# The triangular inverse (trtri) and the products with it
# ---------------------------------------------------------------------------


def _batched_diag_inv(L: torch.Tensor, block: int) -> torch.Tensor:
    """(nb, B, B) inverses of L's diagonal blocks: ONE batched
    ``tri_inv_block`` launch on the kernel path, a batched substitution
    otherwise (f64 oracles, CPU)."""
    if _on_kernel_path(L) and L.dtype == torch.float32:
        return tri_inv_block(L, block)
    nb = L.shape[-1] // block
    blocks = torch.stack([L[i * block:(i + 1) * block, i * block:(i + 1) * block]
                          for i in range(nb)])
    eye = torch.eye(block, dtype=L.dtype, device=L.device).expand(blocks.shape)
    return torch.linalg.solve_triangular(blocks, eye, upper=False)


def lower_inverse(L: torch.Tensor) -> torch.Tensor:
    """``W = L⁻¹`` of a lower-triangular L (lower triangle read): the
    logpdf backward's trtri, the wide solves' and ``covmat.Whitener``'s.

    L is padded with an identity corner to a multiple of ``_BLOCK``, and its
    diagonal blocks invert in one batched launch. A power-of-two block count
    then merges by doubling, ``W = [[W11, 0], [−W22·L21·W11, W22]]``: few
    large products, and strided traffic Σ_levels 3N·s against the row
    panels' Σ r0² ≈ N³/(3B). Any other count goes by row panels,
    ``W[i, :i] = −W_ii·L[i, :i]·W[:i, :i]``. Opens no span and counts
    nothing; its callers do."""
    n = L.shape[-1]
    pad = (-n) % _BLOCK
    if pad:
        L = _pad_identity(L, pad)
    npad, b = n + pad, _BLOCK
    nb = npad // b
    Winv = _batched_diag_inv(L, b)
    W = L.new_zeros((npad, npad))
    for i in range(nb):
        W[i * b:(i + 1) * b, i * b:(i + 1) * b] = Winv[i]
    if nb & (nb - 1):
        for i in range(1, nb):
            r0 = i * b
            W[r0:r0 + b, :r0] = _mm(Winv[i], -_mm(L[r0:r0 + b, :r0], W[:r0, :r0]))
        return W[:n, :n]
    s = b
    while s < npad:
        for base in range(0, npad, 2 * s):
            W11 = W[base:base + s, base:base + s]
            W22 = W[base + s:base + 2 * s, base + s:base + 2 * s]
            L21 = L[base + s:base + 2 * s, base:base + s]
            W[base + s:base + 2 * s, base:base + s] = -tri_mm(W22, _trmm_lr(L21, W11))
        s *= 2
    return W[:n, :n]


def _trmm_lr(X, Wtri):
    """``X @ Wtri`` with Wtri lower-triangular, the merges' right product,
    split as ``tri_mm`` splits (X has as many rows as Wtri)."""
    s = Wtri.shape[0]
    if s < _TRMM_SPLIT or X.shape[0] < _TRMM_RHS:
        return _mm(X, Wtri)
    h = s // 2
    A, C, D = Wtri[:h, :h], Wtri[h:, :h], Wtri[h:, h:]
    left = _trmm_lr(X[:, :h], A) + _mm(X[:, h:], C)
    right = _trmm_lr(X[:, h:], D)
    return torch.cat([left, right], dim=1)


def tri_mm(W: torch.Tensor, B: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """``W B``, or ``Wᵀ B`` with ``transpose``, for a lower-triangular W: the
    one rule for multiplying by ``lower_inverse``'s W. From ``_TRMM_SPLIT``
    rows and ``_TRMM_RHS`` columns of B it splits W in quarters and skips
    the zero one (3 half-products for 4); below either, one GEMM on the
    whole W. The split launches ~30 products at N = 8192: on an H100 the
    GEMM took 0.10 ms at q = 1 against 0.99, 1.03 against 1.22 at q = 384,
    and 1.34 against 1.15 at q = 512. Differentiable in B."""
    s = W.shape[0]
    if s < _TRMM_SPLIT or B.shape[-1] < _TRMM_RHS:
        return _mm(W.T if transpose else W, B)
    h = s // 2
    E, Fm, G = W[:h, :h], W[h:, :h], W[h:, h:]
    if transpose:
        top = tri_mm(E, B[:h], True) + _mm(Fm.T, B[h:])
        bot = tri_mm(G, B[h:], True)
    else:
        top = tri_mm(E, B[:h])
        bot = _mm(Fm, B[:h]) + tri_mm(G, B[h:])
    return torch.cat([top, bot], dim=0)


def _lauum(W: torch.Tensor) -> torch.Tensor:
    """``tril(WᵀW)`` (= tril(K⁻¹) for W = L⁻¹, K = LLᵀ) by output tiles,
    T[a:a+P, b:b+P] = W[a:, a:a+P]ᵀ W[a:, b:b+P] for a ≥ b (rows of W above
    a are zero in W's columns a:a+P), ~2N³/3 GEMM flops instead of the
    dense WᵀW. Needs N divisible by ``_BLOCK``."""
    n = W.shape[-1]
    pw = 512 if n % 512 == 0 else _BLOCK
    T = W.new_zeros((n, n))
    for b in range(0, n, pw):
        for a in range(b, n, pw):
            blk = _mm(W[a:, a:a + pw].T, W[a:, b:b + pw])
            T[a:a + pw, b:b + pw] = blk.tril_() if a == b else blk
    return T


# ---------------------------------------------------------------------------
# Wide TRSM: invert-then-multiply (trtri + TRMMs)
# ---------------------------------------------------------------------------


def _apply_inverse(W: torch.Tensor, B: torch.Tensor, mode: str) -> torch.Tensor:
    """``A⁻¹ B`` from W = L⁻¹, for A = L (``"lower"``), Lᵀ (``"upper"``) or
    LLᵀ (``"chol"``)."""
    if mode == "lower":
        return tri_mm(W, B)
    if mode == "upper":
        return tri_mm(W, B, transpose=True)
    return tri_mm(W, tri_mm(W, B), transpose=True)


_ADJOINT = {"lower": "upper", "upper": "lower", "chol": "chol"}  # the mode of A⁻ᵀ


class _WideSolve(torch.autograd.Function):
    """``X = A⁻¹ B`` for A = L, Lᵀ or LLᵀ (``mode``) by one trtri and
    TRMMs. The adjoints (``pallas_chol.py:1222-1268``) reuse the forward's W
    instead of running a second trtri: B̄ = A⁻ᵀ X̄, and L̄ = −tril(B̄ Xᵀ)
    (lower), −tril(X B̄ᵀ) (upper), −tril((B̄ Xᵀ + X B̄ᵀ) L) (chol)."""

    @staticmethod
    def forward(ctx, L, B, mode):
        with span("ops.wide_solve"):
            LIBRARY_CALLS["wide_inverse"] += 1
            with span("ops.wide_solve.inverse"):
                W = lower_inverse(L)
            with span("ops.wide_solve.trmm"):
                X = _apply_inverse(W, B, mode)
        ctx.mode = mode
        ctx.save_for_backward(L, W, X)
        return X

    @staticmethod
    def backward(ctx, Xbar):
        L, W, X = ctx.saved_tensors
        Bbar = _apply_inverse(W, Xbar, _ADJOINT[ctx.mode])
        Lbar = None
        if ctx.needs_input_grad[0]:
            if ctx.mode == "lower":
                Lbar = -torch.tril(_mm(Bbar, X.T))
            elif ctx.mode == "upper":
                Lbar = -torch.tril(_mm(X, Bbar.T))
            else:
                M = _mm(Bbar, X.T)
                Lbar = -torch.tril(_mm(M + M.T, L))
        return Lbar, Bbar, None


def solve_lower_wide(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``L⁻¹ B`` for a fat RHS via trtri + GEMM (reference ``U' \\ B``)."""
    return _WideSolve.apply(L, B, "lower")


def solve_upper_wide(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``L⁻ᵀ B`` for a fat RHS via trtri + GEMM (reference ``U \\ B``)."""
    return _WideSolve.apply(L, B, "upper")


def chol_solve_wide(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``(L Lᵀ)⁻¹ B`` for a fat RHS: ONE trtri + two TRMMs."""
    return _WideSolve.apply(L, B, "chol")
