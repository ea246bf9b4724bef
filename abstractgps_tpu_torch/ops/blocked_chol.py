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
sweep (``gram_logpdf_core``). The wide solves are trtri + TRMM: a doubling
triangular inverse whose diagonal blocks come from ``tri_inv_block``.

The three hand-written kernels of this module (``csrc/``) each have a plain
torch version beside them: a CUDA tensor launches the kernel, a CPU tensor
takes the plain version. The panel GEMMs, doubling merges and TRMMs are
large products outside any kernel, left to ``torch.matmul`` at IEEE f32
(never TF32), as the JAX package left them to XLA.

Source notes (TPU kernel → this port, bound on the H100, design):

``chol_inv_block`` ← ``abstractgps_tpu/ops/pallas_chol.py:179``
  (``_chol_inv_block``, body :77-175). Latency-bound: a chain of B column
  steps on a 128² block. One CTA holds the block and its inverse in 128 KB
  of shared memory; the factor is right-looking column by column, the
  inverse exact forward substitution (no Newton polish needed).
``slab_factor`` ← ``abstractgps_tpu/ops/pallas_chol.py:339``
  (``_slab_factor``, ``_slab_body`` :298). Operation-bound in principle
  (W³/3 flops at W = 1024), but a 4 MB slab does not fit one SM's shared
  memory as it fit VMEM: the slab stays in device memory (L2-resident),
  and per diagonal block a short fixed launch sequence runs the block
  routine above, then the slab-local panel L21 = P·W_kᵀ and the trailing
  update S22 −= L21·L21ᵀ as hand-written tiled FP32 kernels.
``tri_inv_block`` ← ``abstractgps_tpu/ops/pallas_chol.py:405``
  (``_tri_inv_block``, body :368-401). Latency-bound per block; batched
  with one CTA per diagonal block, read in place through strides.

Layouts: ``slab_factor`` returns the plain-lower slab factor L (the TPU
kernel returned Lᵀ, a store-layout choice) and the (W/B, B, B) inverses of
its diagonal blocks; ``chol_inv_block`` returns (L, L⁻¹), plain lower.

Backward passes are not ported yet: the autograd Functions below raise
``NotImplementedError`` from ``backward`` (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import cuda
from .precision import full_f32

_INTERPRET = False  # tests: route CPU f32 tensors through the plain versions
_MIN_N = 1024       # below this torch.linalg is already fine
_BLOCK = 128        # diagonal block width
_OUTER = 1024       # outer slab width of the two-level sweep
_SLAB = True        # full-width slabs go through slab_factor
_WIDE_RHS = 256     # the trtri amortizes over this many RHS columns
_TRMM_SPLIT = 2048  # split dense x triangular products at/above this size

_BACKWARD_TODO = ("backward of {} is not ported yet: ROADMAP.md queue 1, "
                  "item 1 (the training path)")


def set_interpret(flag: bool) -> None:
    global _INTERPRET
    _INTERPRET = flag


def _on_kernel_path(t: torch.Tensor) -> bool:
    return _INTERPRET or t.is_cuda


def should_use_pallas(A: torch.Tensor) -> bool:
    """Gate for ``pallas_cholesky``: f32 on the card, N ≥ _MIN_N."""
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


def should_use_wide_solve(L: torch.Tensor, B: torch.Tensor) -> bool:
    """Gate for the trtri+GEMM solves: f32 on the card, large N, FAT rhs
    (q ≥ _WIDE_RHS; a thin RHS keeps substitution, where the trtri cost
    dominates)."""
    if not _on_kernel_path(L):
        return False
    if L.ndim != 2 or L.dtype != torch.float32 or B.dtype != torch.float32:
        return False
    q = 1 if B.ndim == 1 else B.shape[-1]
    return L.shape[-1] >= _MIN_N and q >= _WIDE_RHS


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Panel GEMM at IEEE f32 whatever the precision policy (TF32 would
    corrupt the factorization)."""
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


def chol_inv_block_plain(A: torch.Tensor):
    """Plain version of ``chol_inv_block``: (L, L⁻¹) of one SPD block by
    right-looking column steps; lower triangle read; a negative pivot
    gives NaN."""
    M = torch.tril(A).clone()
    for j in range(A.shape[0]):
        d = torch.sqrt(M[j, j])
        col = M[j + 1:, j] / d
        M[j, j] = d
        M[j + 1:, j] = col
        M[j + 1:, j + 1:] -= col[:, None] * col[None, :]
    L = torch.tril(M)
    return L, _invert_lower_plain(L)


def chol_inv_block(A: torch.Tensor):
    """(L, L⁻¹) of one (B, B) SPD block, B ≤ 128, lower triangle read (rows
    may be strided). CUDA: one launch of ``csrc/chol_inv_block.cu``."""
    if not A.is_cuda:
        return chol_inv_block_plain(A)
    A = _f32_rows(A, "chol_inv_block")
    B = A.shape[0]
    if A.shape[1] != B or B > 128:
        raise ValueError(f"chol_inv_block: bad block shape {tuple(A.shape)}")
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
    if S.shape[1] != W or W % block or block > 128:
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
    of the (n, n) matrix L (lower triangles read; rows may be strided).
    CUDA: one batched launch of ``csrc/tri_inv_block.cu``."""
    if not L.is_cuda:
        return tri_inv_block_plain(L, block)
    L = _f32_rows(L, "tri_inv_block")
    n = L.shape[0]
    if L.shape[1] != n or n % block or block > 128:
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
    (npad, q), the blocks of ``Z = L⁻¹ rhs`` computed while sweeping."""
    slabs = []
    R = None if rhs is None else rhs.clone()
    zs = []
    r0 = 0
    while r0 < npad:
        w = min(_OUTER, npad - r0)
        S = panel_fn(r0, w)  # (npad - r0, w)
        for b_j, Sf_j in slabs:
            o = r0 - b_j
            S = S - _mm(Sf_j[o:], Sf_j[o:o + w].T)
        rows = npad - r0
        Sf = S.new_zeros((rows, w), dtype=dtype)
        if _SLAB and w == _OUTER:
            L_slab, Ws = slab_factor(S[:w].contiguous(), block)
            Sf[:w] = L_slab
            zs_slab = []
            if R is not None:
                # blocked forward substitution within the slab, reusing the
                # slab's diagonal-block inverses
                for j in range(w // block):
                    jb = j * block
                    rj = R[r0 + jb:r0 + jb + block]
                    if j:
                        rj = rj - _mm(L_slab[jb:jb + block, :jb], torch.cat(zs_slab))
                    zs_slab.append(_mm(Ws[j], rj))
                zs.extend(zs_slab)
            if rows > w:
                for j in range(w // block):
                    jb = j * block
                    P = S[w:, jb:jb + block]
                    if j:
                        P = P - _mm(Sf[w:, :jb], L_slab[jb:jb + block, :jb].T)
                    Sf[w:, jb:jb + block] = _mm(P, Ws[j].T)
            if R is not None and r0 + w < npad:
                R[r0 + w:] -= _mm(Sf[w:], torch.cat(zs_slab))
            slabs.append((r0, Sf))
            r0 += w
            continue
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


class _PallasCholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A):
        return _blocked_cholesky_impl(A, _BLOCK)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(_BACKWARD_TODO.format("pallas_cholesky"))


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


class _CholeskyGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, x, noise_diag, *params):
        return _cholesky_gram_impl(kernel, x, noise_diag, _BLOCK)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(_BACKWARD_TODO.format("cholesky_gram"))


def cholesky_gram(kernel, x, noise_diag):
    """``chol(K(x, x) + diag(noise_diag))`` without materialising K."""
    return _CholeskyGram.apply(kernel, x, noise_diag, *kernel.parameters())


# ---------------------------------------------------------------------------
# Fused gram → Cholesky → logpdf
# ---------------------------------------------------------------------------


def _fused_logpdf(kernel, x, noise_diag, delta):
    """(logpdf, (slabs, zs, n, npad)): the whitening solve and logdet ride
    the sweep; the N×N factor is never assembled."""
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
        out, _ = _fused_logpdf(kernel, x, noise_diag, delta)
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(_BACKWARD_TODO.format("gram_logpdf_core"))


def gram_logpdf_core(kernel, x, noise_diag, delta):
    """``-0.5 (n log2π + logdet(K+Σ) + δᵀ(K+Σ)⁻¹δ)`` per column of δ,
    without materialising K. ``delta`` is (n,) or (n, q); returns a scalar
    or (q,)."""
    return _GramLogpdfCore.apply(kernel, x, noise_diag, delta, *kernel.parameters())


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
# Triangular inverse by doubling merges (trtri)
# ---------------------------------------------------------------------------


def _inv_lower(L: torch.Tensor) -> torch.Tensor:
    """Inverse of (a batch of) small lower-triangular blocks by
    substitution (the non-kernel path: f64 oracles, CPU)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _pallas_diag_inv(Lii: torch.Tensor) -> torch.Tensor:
    """Inverse of one diagonal block: ``tri_inv_block`` on the kernel path,
    substitution otherwise."""
    if _on_kernel_path(Lii) and Lii.dtype == torch.float32:
        return tri_inv_block(Lii, Lii.shape[0])[0]
    return _inv_lower(Lii)


def _batched_diag_inv(L: torch.Tensor, block: int) -> torch.Tensor:
    """(nb, B, B) inverses of L's diagonal blocks — ONE batched launch on
    the kernel path."""
    if _on_kernel_path(L) and L.dtype == torch.float32:
        return tri_inv_block(L, block)
    nb = L.shape[-1] // block
    return _inv_lower(torch.stack([
        L[i * block:(i + 1) * block, i * block:(i + 1) * block] for i in range(nb)]))


def _inv_lower_blocked(L: torch.Tensor, block: int) -> torch.Tensor:
    """``W = L⁻¹`` (lower) by doubling merges
    ``W = [[W11, 0], [−W22·L21·W11, W22]]`` over the batched diagonal-block
    inverses. Needs n a power-of-two multiple of ``block``; other
    multiples take the row-panel scheme."""
    n = L.shape[-1]
    nb = n // block
    if nb & (nb - 1):
        return _inv_lower_blocked_rowpanel(L, block)
    Winv = _batched_diag_inv(L, block)
    W = L.new_zeros((n, n))
    for i in range(nb):
        W[i * block:(i + 1) * block, i * block:(i + 1) * block] = Winv[i]
    s = block
    while s < n:
        for base in range(0, n, 2 * s):
            W11 = W[base:base + s, base:base + s]
            W22 = W[base + s:base + 2 * s, base + s:base + 2 * s]
            L21 = L[base + s:base + 2 * s, base:base + s]
            W[base + s:base + 2 * s, base:base + s] = -_trmm_ll(W22, _trmm_lr(L21, W11))
        s *= 2
    return W


def _trmm_lr(X, Wtri):
    """``X @ Wtri`` with Wtri LOWER-triangular: one split level drops the
    zero upper-right quarter (3 half-GEMMs instead of 4)."""
    s = Wtri.shape[0]
    if s < _TRMM_SPLIT:
        return _mm(X, Wtri)
    h = s // 2
    A, C, D = Wtri[:h, :h], Wtri[h:, :h], Wtri[h:, h:]
    left = _trmm_lr(X[:, :h], A) + _mm(X[:, h:], C)
    right = _trmm_lr(X[:, h:], D)
    return torch.cat([left, right], dim=1)


def _trmm_ll(Wtri, X):
    """``Wtri @ X`` with Wtri LOWER-triangular (same split)."""
    s = Wtri.shape[0]
    if s < _TRMM_SPLIT:
        return _mm(Wtri, X)
    h = s // 2
    E, Fm, G = Wtri[:h, :h], Wtri[h:, :h], Wtri[h:, h:]
    top = _trmm_ll(E, X[:h])
    bot = _mm(Fm, X[:h]) + _trmm_ll(G, X[h:])
    return torch.cat([top, bot], dim=0)


def _trmm_ul(Wtri, X):
    """``Wtriᵀ @ X`` with Wtri LOWER-triangular (upper-left TRMM)."""
    s = Wtri.shape[0]
    if s < _TRMM_SPLIT:
        return _mm(Wtri.T, X)
    h = s // 2
    E, Fm, G = Wtri[:h, :h], Wtri[h:, :h], Wtri[h:, h:]
    top = _trmm_ul(E, X[:h]) + _mm(Fm.T, X[h:])
    bot = _trmm_ul(G, X[h:])
    return torch.cat([top, bot], dim=0)


def _inv_lower_blocked_rowpanel(L: torch.Tensor, block: int) -> torch.Tensor:
    """Row-panel forward-substitution trtri (non-power-of-two fallback);
    each diagonal block goes through ``_pallas_diag_inv``."""
    n = L.shape[-1]
    W = L.new_zeros((n, n))
    for i in range(n // block):
        r0 = i * block
        Lii_inv = _pallas_diag_inv(L[r0:r0 + block, r0:r0 + block])
        W[r0:r0 + block, r0:r0 + block] = Lii_inv
        if i:
            rhs = -_mm(L[r0:r0 + block, :r0], W[:r0, :r0])
            W[r0:r0 + block, :r0] = _mm(Lii_inv, rhs)
    return W


# ---------------------------------------------------------------------------
# Wide TRSM: invert-then-multiply (trtri + one GEMM)
# ---------------------------------------------------------------------------


def _padded_tri(L: torch.Tensor, block: int):
    n = L.shape[-1]
    pad = (-n) % block
    return (_pad_identity(L, pad) if pad else L), n


def _wide_inverse(L: torch.Tensor) -> torch.Tensor:
    Lp, n = _padded_tri(L, _BLOCK)
    return _inv_lower_blocked(Lp, _BLOCK)[:n, :n]


class _SolveLowerWide(torch.autograd.Function):
    @staticmethod
    def forward(ctx, L, B):
        return _trmm_ll(_wide_inverse(L), B)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(_BACKWARD_TODO.format("solve_lower_wide"))


class _SolveUpperWide(torch.autograd.Function):
    @staticmethod
    def forward(ctx, L, B):
        return _trmm_ul(_wide_inverse(L), B)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(_BACKWARD_TODO.format("solve_upper_wide"))


class _CholSolveWide(torch.autograd.Function):
    @staticmethod
    def forward(ctx, L, B):
        W = _wide_inverse(L)
        return _trmm_ul(W, _trmm_ll(W, B))

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(_BACKWARD_TODO.format("chol_solve_wide"))


def solve_lower_wide(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``L⁻¹ B`` for a fat RHS via trtri + GEMM (reference ``U' \\ B``)."""
    return _SolveLowerWide.apply(L, B)


def solve_upper_wide(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``L⁻ᵀ B`` for a fat RHS via trtri + GEMM (reference ``U \\ B``)."""
    return _SolveUpperWide.apply(L, B)


def chol_solve_wide(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``(L Lᵀ)⁻¹ B`` for a fat RHS: ONE trtri + two TRMMs."""
    return _CholSolveWide.apply(L, B)
