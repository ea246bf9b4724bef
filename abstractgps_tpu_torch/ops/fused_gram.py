"""Fused gram-matrix kernel for isotropic kernels, and its backward.

Counterpart of the JAX package's ``ops/pallas_gram.py``. Each output entry is

    d² = Σ_k (x_ik − z_jk)²      (f32, from the differences)
    K  = g(d²)                  (the kernel's map, fused)

so d² never reaches device memory. The JAX package forms d² as
‖x_i‖² + ‖z_j‖² − 2·x_i·z_j, which rounds to eps·‖x‖²: on a 1-D time axis
scaled to [75, 100] that is ~1e-2 in d², and the f32 logpdf of 2048 such
points lost 6e-3 of its value and most of its σ² gradient. The port's
kernels and plain versions take the differences, whose rounding is
relative to d². On a CUDA tensor ``gram_tile`` launches the hand-written
kernel ``csrc/gram_tile.cu``; on a CPU tensor it runs ``gram_tile_plain``,
the same function in plain torch.

``gram_tile`` — source note:
  replaces ``abstractgps_tpu/ops/pallas_gram.py:128`` (``_fused_fwd_impl``,
  ``pallas_call`` at :160). On the H100 it is bound by bytes: it writes
  n·m·4 bytes and does 3·D flops and the map per entry. Design: a
  128×128 output tile per CTA, the family and feature width as template
  parameters; x's rows and z's rows (transposed) staged at their true width
  with ``cp.async``; a thread owns 4 contiguous columns (their features in
  registers) and stores them as one
  ``float4`` streaming store where the rows allow it; FP32 FMA only. The
  kernel masks its ragged edge, so inputs are not padded to the tile (the
  Pallas ``_pad_rows`` has no counterpart). Hyperparameters of g (RQ α, γ)
  go in a small device buffer, never through a host read.

``gram_bwd`` — source note (``csrc/gram_bwd.cu``):
  replaces ``abstractgps_tpu/ops/pallas_gram.py:185`` (``_bwd_pass``,
  ``pallas_call`` at :289; driven by ``_fused_vjp_bwd`` :325), the VJP of
  the fused gram: x̄ of the row operand and the map hyperparameter's bar.
  Bound by bytes: it reads the cotangent once per pass (C + Cᵀ for a
  symmetric gram). Design: a grid of 64-row blocks × ``column_split_count``
  column ranges, so the card fills at any (n, m); each CTA streams its
  cotangent tiles through a ``cp.async`` double buffer, rebuilds d² with
  FP32 FMA, applies the map's VJP and accumulates Σ w·(x_r − z_c) in
  registers (one row a thread, up to 32 features; wider inputs add a grid
  dimension of 32-feature chunks). No atomics: per-split partials of x̄ and FP64 per-CTA bars are
  added in a fixed order by a small last launch.

``logpdf_contraction`` — source note (``csrc/logpdf_contraction.cu``):
  replaces ``abstractgps_tpu/ops/pallas_gram.py:359`` (``logpdf_contraction``,
  ``pallas_call`` at :458), the logpdf backward's contraction with the
  cotangent C = ½(α·ḡ·αᵀ − ḡΣ·sym(T)) built per tile from T = tril(K⁻¹).
  Bound by bytes: it needs T's lower triangle once (reading it twice,
  n²·4 bytes), C is never stored. The column-split sweep of kernel 6
  (``csrc/gram_sweep.cuh``) with T's tiles as the cotangent: a lower tile
  read as it lies, an upper one as its mirrored lower tile, so T's strict
  upper triangle is never read; the nearly cancelling σ² sum accumulates
  in FP64 (the TPU kernel's Neumaier sums).

Both return the same bits for the same inputs (no float atomics).
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import span
from . import cuda
from .distance import safe_sqrt
from .precision import full_f32

__all__ = [
    "FAMILIES",
    "set_enabled",
    "set_interpret",
    "should_use_kernel",
    "gram_tile",
    "gram_tile_plain",
    "gram_bwd",
    "gram_bwd_plain",
    "column_split_count",
    "logpdf_contraction",
    "logpdf_contraction_plain",
    "fused_isotropic_gram",
    "plain_isotropic_gram",
]

_INTERPRET = False  # tests: route CPU f32 tensors through the plain version
_ENABLED = True     # False: every tensor takes the unfused torch formulation
_MIN_SIZE = 512 * 512  # below this the plain torch path is already fine

# epilogue ids of csrc/gram_tile.cu, by kernel class FAMILY
FAMILIES = {
    0: "sqexponential",
    1: "exponential",
    2: "matern32",
    3: "matern52",
    4: "rationalquadratic",
    5: "gammaexponential",
    6: "cosine",
}


def set_enabled(flag: bool) -> None:
    """``False`` turns the fused gram and its backward kernels off: the gate
    returns False, so a card tensor takes the unfused torch formulation (the
    library path, as a CPU f64 tensor does). The choice is made before any
    kernel is tried; it is no fallback."""
    global _ENABLED
    _ENABLED = flag


def set_interpret(flag: bool) -> None:
    global _INTERPRET
    _INTERPRET = flag


def _on_kernel_path(*ts: torch.Tensor) -> bool:
    return _ENABLED and (_INTERPRET or all(t.is_cuda for t in ts))


def should_use_kernel(x: torch.Tensor, z: torch.Tensor) -> bool:
    """Gate: f32 on the card (or under ``set_interpret(True)``), ≥ _MIN_SIZE
    pairs; False under ``set_enabled(False)``."""
    if not _on_kernel_path(x, z):
        return False
    if x.dtype != torch.float32 or z.dtype != torch.float32:
        return False
    return x.shape[0] * z.shape[0] >= _MIN_SIZE


def _apply_map(family: int, d2: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    if family == 0:
        return torch.exp(-0.5 * d2)
    if family == 1:
        return torch.exp(-safe_sqrt(d2))
    if family == 2:
        t = math.sqrt(3.0) * safe_sqrt(d2)
        return (1.0 + t) * torch.exp(-t)
    if family == 3:
        t = math.sqrt(5.0) * safe_sqrt(d2)
        return (1.0 + t + t * t / 3.0) * torch.exp(-t)
    if family == 4:
        return torch.pow(1.0 + d2 / (2.0 * p[0]), -p[0])
    if family == 5:
        pos = d2 > 0.0
        safe = torch.where(pos, d2, torch.ones_like(d2))
        return torch.exp(-torch.where(pos, torch.pow(safe, 0.5 * p[0]),
                                      torch.zeros_like(d2)))
    if family == 6:
        return torch.cos(math.pi * safe_sqrt(d2))
    raise ValueError(f"unknown gram family {family}")


def _map_vjp(family: int, d2: torch.Tensor, p: torch.Tensor):
    """``(g, ∂g/∂d², ∂g/∂p)`` of the map at d², in closed form: the
    derivatives that autodiff of the JAX package's ``_apply_sqdist`` gives
    (``safe_sqrt`` has derivative 0 at d² = 0, so every sqrt-based family
    has ∂g/∂d² = 0 there). ``p[0]`` is RQ's α or γ; ∂g/∂p is 0 for the
    families without one. The kernels' ``agp::map_vjp`` is the same."""
    zero = torch.zeros_like(d2)
    pos = d2 > 0.0
    s = safe_sqrt(d2)
    s_safe = torch.where(pos, s, torch.ones_like(d2))
    if family == 0:
        g = torch.exp(-0.5 * d2)
        return g, -0.5 * g, zero
    if family == 1:
        g = torch.exp(-s)
        return g, torch.where(pos, -0.5 * g / s_safe, zero), zero
    if family == 2:
        t = math.sqrt(3.0) * s
        e = torch.exp(-t)
        return (1.0 + t) * e, torch.where(pos, -1.5 * e, zero), zero
    if family == 3:
        t = math.sqrt(5.0) * s
        e = torch.exp(-t)
        return ((1.0 + t + t * t / 3.0) * e,
                torch.where(pos, -(5.0 / 6.0) * (1.0 + t) * e, zero), zero)
    if family == 4:
        a = p[0]
        u = d2 / (2.0 * a)
        b = 1.0 + u
        g = torch.pow(b, -a)
        return g, -0.5 * g / b, g * (u / b - torch.log1p(u))
    if family == 5:
        gam = p[0]
        safe = torch.where(pos, d2, torch.ones_like(d2))
        pw = torch.where(pos, torch.pow(safe, 0.5 * gam), zero)
        g = torch.exp(-pw)
        return (g, torch.where(pos, -0.5 * gam * g * pw / safe, zero),
                torch.where(pos, -0.5 * g * pw * torch.log(safe), zero))
    if family == 6:
        g = torch.cos(math.pi * s)
        return g, torch.where(pos, -0.5 * math.pi * torch.sin(math.pi * s) / s_safe, zero), zero
    raise ValueError(f"unknown gram family {family}")


def _sqdist_plain(x, z, symmetric: bool) -> torch.Tensor:
    """d² as the kernels form it: Σ_k (x_ik − z_jk)², summed from feature 0
    (an exact-zero diagonal when symmetric). The differences keep d²'s
    rounding relative to d² itself, where ‖x‖² + ‖z‖² − 2x·z would round to
    eps·‖x‖² for inputs far from the origin."""
    d2 = torch.zeros((x.shape[0], z.shape[0]), dtype=x.dtype, device=x.device)
    for k in range(x.shape[1]):
        df = x[:, k, None] - z[None, :, k]
        d2 += df * df
    if symmetric:
        d2.diagonal().zero_()
    return d2


def _weighted_differences(w, x, z) -> torch.Tensor:
    """x̄ of a sweep before its scale: Σ_c w_rc (x_r − z_c), feature by
    feature (the kernels' form, free of the cancellation of
    rowsum(w)·x_r − w·z)."""
    out = torch.empty_like(x)
    for k in range(x.shape[1]):
        out[:, k] = torch.sum(w * (x[:, k, None] - z[None, :, k]), dim=1)
    return out


def gram_tile_plain(x, z, family: int, params, symmetric: bool = False):
    """Plain torch version of ``gram_tile`` (any n, m, D; exact f32)."""
    return _apply_map(family, _sqdist_plain(x, z, symmetric), params)


def _params_buffer(params, device, dtype=torch.float32) -> torch.Tensor:
    """The map's hyperparameters as a small tensor on ``device`` (the
    kernels read it there: no host read stalls the stream)."""
    if not params:
        return torch.zeros(1, dtype=dtype, device=device)
    return torch.stack([torch.as_tensor(p).detach().reshape(())
                        .to(dtype) for p in params]).to(device)


def gram_tile(x: torch.Tensor, z: torch.Tensor, family: int, params=(),
              symmetric: bool = False) -> torch.Tensor:
    """``g(d²(x, z))`` as an (n, m) f32 tensor; ``params`` are the map's
    hyperparameters (0-dim tensors). CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    buf = _params_buffer(params, x.device)
    if not x.is_cuda:
        return gram_tile_plain(x, z, family, buf, symmetric)
    if not z.is_cuda or z.device != x.device:
        raise ValueError("gram_tile: x and z must be on the same CUDA device")
    if x.dtype != torch.float32 or z.dtype != torch.float32:
        raise TypeError(f"gram_tile takes f32, got {x.dtype}/{z.dtype}")
    if x.ndim != 2 or z.ndim != 2 or x.shape[1] != z.shape[1]:
        raise ValueError(f"gram_tile: bad shapes {tuple(x.shape)}, {tuple(z.shape)}")
    if family not in FAMILIES:
        raise ValueError(f"unknown gram family {family}")
    x, z = x.contiguous(), z.contiguous()
    n, d = x.shape
    m = z.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    lib = cuda.library()
    with torch.cuda.device(x.device):
        err = lib.agp_gram_tile(x.data_ptr(), z.data_ptr(), out.data_ptr(),
                                buf.data_ptr(), n, m, d, family, int(symmetric),
                                cuda.stream(x))
    cuda.check(err, "gram_tile")
    cuda.LAUNCHES["gram_tile"] += 1
    return out


def plain_isotropic_gram(kernel, x: torch.Tensor, z: torch.Tensor,
                         symmetric: bool = False) -> torch.Tensor:
    """Unfused formulation (``pairwise_sqdist`` then the kernel's map), the
    path below the gate; counterpart of the Pallas module's
    ``_xla_isotropic_gram``."""
    from .distance import pairwise_sqdist

    return kernel._apply_sqdist(pairwise_sqdist(x, None if symmetric else z))


# ---------------------------------------------------------------------------
# Backward: the gram VJP (kernel 6) and the logpdf contraction (kernel 5)
# ---------------------------------------------------------------------------

_MODES = {"plain": 0, "transpose": 1, "sym": 2}
_TILE = 64  # rows of a row block, columns of a column tile (csrc/gram_sweep.cuh)
# gram_bwd's grid aims at this many CTAs per SM of one H100 (132 SMs); a
# constant, so that the split, and with it the bits, follow from (n, m)
_SPLIT_CTAS = 8 * 132


def column_split_count(n: int, m: int) -> int:
    """S, the column splits of the backward sweeps' grid (``gram_bwd``,
    ``logpdf_contraction``): the least count that
    gives ``_SPLIT_CTAS`` CTAs with the ⌈n/64⌉ row blocks, at most the
    T = ⌈m/64⌉ column tiles. A function of (n, m) alone; the kernel gives
    split s the tiles ``[s·T // S, (s+1)·T // S)``."""
    tiles = -(-m // _TILE)
    return min(tiles, -(-_SPLIT_CTAS // -(-n // _TILE)))


def gram_bwd_plain(x, z, C, family: int, params, symmetric: bool = False,
                   mode: str = "plain"):
    """Plain version of ``gram_bwd``."""
    Ct = C.T if mode == "transpose" else C
    if mode == "sym":
        Ct = C + C.T
    d2 = _sqdist_plain(x, z, symmetric)
    _, dg, dp = _map_vjp(family, d2, params)
    w = Ct * dg
    if symmetric:
        w.diagonal().zero_()
    xbar = 2.0 * _weighted_differences(w, x, z)
    pbar = torch.sum((Ct * dp).double())
    return xbar, (0.5 * pbar if mode == "sym" else pbar)


def _check_f32_cuda(name, *ts):
    dev = ts[0].device
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes f32, got {t.dtype}")


def gram_bwd(x: torch.Tensor, z: torch.Tensor, C: torch.Tensor, family: int,
             params=(), symmetric: bool = False, mode: str = "plain"):
    """VJP of ``g(d²(x, z))`` against the cotangent ``C``: ``(x̄, p̄)`` with
    x̄ (n, D) the row operand's cotangent and p̄ the f64 sum of C·∂g/∂p over
    the map's hyperparameter. ``mode``: ``"plain"`` (C is (n, m)),
    ``"transpose"`` (C is (m, n), read transposed: z's cotangent of a cross
    gram with the operands swapped), ``"sym"`` (z is x: one sweep over
    C + Cᵀ gives the total x̄, and p̄ is halved). CUDA: one call of
    ``csrc/gram_bwd.cu`` (the split sweep and the in-order sum of its
    partials)."""
    if not x.is_cuda:
        buf = _params_buffer(params, x.device, x.dtype)
        return gram_bwd_plain(x, z, C, family, buf, symmetric, mode)
    _check_f32_cuda("gram_bwd", x, z, C)
    if x.ndim != 2 or z.ndim != 2 or x.shape[1] != z.shape[1]:
        raise ValueError(f"gram_bwd: bad shapes {tuple(x.shape)}, {tuple(z.shape)}")
    if family not in FAMILIES or mode not in _MODES:
        raise ValueError(f"gram_bwd: bad family {family} or mode {mode!r}")
    n, d = x.shape
    m = z.shape[0]
    want = (m, n) if mode == "transpose" else (n, m)
    if tuple(C.shape) != want or (mode == "sym" and n != m):
        raise ValueError(f"gram_bwd: cotangent {tuple(C.shape)}, expected {want}")
    x, z = x.contiguous(), z.contiguous()
    if C.stride(1) != 1:
        C = C.contiguous()
    buf = _params_buffer(params, x.device)
    splits = column_split_count(n, m)
    xbar = torch.empty((n, d), dtype=torch.float32, device=x.device)
    part_x = torch.empty((splits, n, d), dtype=torch.float32, device=x.device)
    part_p = torch.empty(-(-n // _TILE) * splits, dtype=torch.float64, device=x.device)
    pbar = torch.empty(1, dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        err = cuda.library().agp_gram_bwd(
            x.data_ptr(), z.data_ptr(), C.data_ptr(), C.stride(0), buf.data_ptr(),
            xbar.data_ptr(), part_x.data_ptr(), part_p.data_ptr(),
            pbar.data_ptr(), n, m, d, family, int(symmetric), _MODES[mode], splits,
            cuda.stream(x))
    cuda.check(err, "gram_bwd")
    cuda.LAUNCHES["gram_bwd"] += 1
    return xbar, (0.5 * pbar[0] if mode == "sym" else pbar[0])


def logpdf_contraction_plain(xp, s2, alpha_g, alpha, gsum, T, family: int, params):
    """Plain version of ``logpdf_contraction`` (forms C in full)."""
    Tl = torch.tril(T)
    Tsym = Tl + Tl.T - torch.diag(torch.diagonal(Tl))
    with full_f32():
        Ct = 0.5 * (alpha_g @ alpha.T - gsum * Tsym)
    d2 = _sqdist_plain(xp, xp, True)
    g, dg, dp = _map_vjp(family, d2, params)
    w = Ct * s2 * dg
    w.diagonal().zero_()
    xbar = 4.0 * _weighted_differences(w, xp, xp)
    s2bar = torch.sum((Ct * g).double())
    pbar = torch.sum((Ct * s2 * dp).double())
    return s2bar, pbar, xbar


def logpdf_contraction(xp: torch.Tensor, s2: torch.Tensor, alpha_g: torch.Tensor,
                       alpha: torch.Tensor, gsum: torch.Tensor, T: torch.Tensor,
                       family: int, params=()):
    """Cotangents of ``F = ⟨C, s2·g(d²(x′, x′))⟩`` for the logpdf cotangent
    ``C = ½(α_g αᵀ − gsum·(T + Tᵀ − diag T))``, T = tril(K⁻¹) (lower
    triangle read; T may be a strided view): ``(s̄2, p̄, x̄′)``, the scalars
    as f64 0-dim tensors. x′ (n, D), α and α_g = α·ḡ (n, q), s2 and gsum
    0-dim tensors. CUDA: one call of ``csrc/logpdf_contraction.cu`` (the
    split sweep and the in-order sum of its partials)."""
    if not xp.is_cuda:
        buf = _params_buffer(params, xp.device, xp.dtype)
        return logpdf_contraction_plain(xp, s2, alpha_g, alpha, gsum, T, family, buf)
    _check_f32_cuda("logpdf_contraction", xp, alpha_g, alpha, T, s2, gsum)
    n, d = xp.shape
    q = alpha.shape[1]
    if (tuple(alpha_g.shape) != (n, q) or tuple(alpha.shape) != (n, q)
            or tuple(T.shape) != (n, n) or s2.numel() != 1 or gsum.numel() != 1):
        raise ValueError("logpdf_contraction: bad shapes")
    if family not in FAMILIES:
        raise ValueError(f"unknown gram family {family}")
    xp, alpha_g, alpha = xp.contiguous(), alpha_g.contiguous(), alpha.contiguous()
    if T.stride(1) != 1:
        T = T.contiguous()
    p0 = _params_buffer(params, xp.device)[:1]
    scal = torch.cat([p0, s2.reshape(1), gsum.reshape(1)])
    splits = column_split_count(n, n)
    xbar = torch.empty((n, d), dtype=torch.float32, device=xp.device)
    part_x = torch.empty((splits, n, d), dtype=torch.float32, device=xp.device)
    part_s = torch.empty(2 * -(-n // _TILE) * splits, dtype=torch.float64, device=xp.device)
    sums = torch.empty(2, dtype=torch.float64, device=xp.device)
    with torch.cuda.device(xp.device):
        err = cuda.library().agp_logpdf_contraction(
            xp.data_ptr(), alpha_g.data_ptr(), alpha.data_ptr(), T.data_ptr(), T.stride(0),
            scal.data_ptr(), xbar.data_ptr(), part_x.data_ptr(),
            part_s.data_ptr(), sums.data_ptr(), n, d, q, family, splits, cuda.stream(xp))
    cuda.check(err, "logpdf_contraction")
    cuda.LAUNCHES["logpdf_contraction"] += 1
    return sums[1], sums[0], xbar


class _FusedGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, family, symmetric, x, z, *params):
        ctx.family, ctx.symmetric, ctx.same = family, symmetric, z is x
        ctx.save_for_backward(x, z, *params)
        with span("ops.gram"):
            return gram_tile(x, z, family, params, symmetric)

    @staticmethod
    def backward(ctx, C):
        with span("ops.gram_backward"):
            return _FusedGram._backward(ctx, C)

    @staticmethod
    def _backward(ctx, C):
        x, z, *params = ctx.saved_tensors
        fam, sym = ctx.family, ctx.symmetric
        need_x, need_z = ctx.needs_input_grad[2:4]
        need_p = any(ctx.needs_input_grad[4:])
        xbar = zbar = pbar = None
        if ctx.same:
            # z IS x: one sweep over C + Cᵀ gives the total cotangent
            if need_x or need_z or need_p:
                xbar, pbar = gram_bwd(x, x, C, fam, params, sym, "sym")
        else:
            if need_x or need_p:
                xbar, pbar = gram_bwd(x, z, C, fam, params, sym, "plain")
            if need_z:
                zbar, _ = gram_bwd(z, x, C, fam, params, sym, "transpose")
        pbars = [None if pbar is None else pbar.to(p.dtype).reshape(p.shape) for p in params]
        return (None, None, xbar, zbar, *pbars)


def fused_isotropic_gram(kernel, x: torch.Tensor, z: torch.Tensor,
                         symmetric: bool = False) -> torch.Tensor:
    """Fused gram of an isotropic kernel (its ``FAMILY`` and ``_map_params``)
    between the rows of x and z; differentiable through ``gram_bwd``."""
    return _FusedGram.apply(kernel.FAMILY, symmetric, x, z, *kernel._map_params())
