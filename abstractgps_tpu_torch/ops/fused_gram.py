"""Fused gram-matrix kernel for isotropic kernels (forward).

Counterpart of the JAX package's ``ops/pallas_gram.py``. Each output entry is

    d² = max(‖x_i‖² + ‖z_j‖² − 2·x_i·z_j, 0)      (exact f32)
    K  = g(d²)                                   (the kernel's map, fused)

so d² never reaches device memory. On a CUDA tensor ``gram_tile`` launches
the hand-written kernel ``csrc/gram_tile.cu``; on a CPU tensor it runs
``gram_tile_plain``, the same function in plain torch.

``gram_tile`` — source note:
  replaces ``abstractgps_tpu/ops/pallas_gram.py:128`` (``_fused_fwd_impl``,
  ``pallas_call`` at :160). On the H100 it is bound by bytes: it writes
  n·m·4 bytes and does 2·D flops per entry at D = 8. Design: 64×64 output
  tiles per CTA, x/z row tiles staged in shared memory, norms from the
  staged values, the map g in the epilogue, FP32 FMA only. The kernel masks
  its ragged edge, so inputs are not padded to the tile (the Pallas
  ``_pad_rows`` has no counterpart). Hyperparameters of g (RQ α, γ) go in a
  small device buffer, never through a host read.

The backward (the Pallas ``_bwd_pass``) is not ported yet: differentiating
through ``fused_isotropic_gram`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import math

import torch

from . import cuda
from .distance import safe_sqrt

__all__ = [
    "FAMILIES",
    "set_interpret",
    "should_use_kernel",
    "gram_tile",
    "gram_tile_plain",
    "fused_isotropic_gram",
    "plain_isotropic_gram",
]

_INTERPRET = False  # tests: route CPU f32 tensors through the plain version
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


def set_interpret(flag: bool) -> None:
    global _INTERPRET
    _INTERPRET = flag


def should_use_kernel(x: torch.Tensor, z: torch.Tensor) -> bool:
    """Gate: f32 on the card (or under ``set_interpret(True)``), ≥ _MIN_SIZE
    pairs."""
    if not (_INTERPRET or (x.is_cuda and z.is_cuda)):
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


def gram_tile_plain(x, z, family: int, params, symmetric: bool = False):
    """Plain torch version of ``gram_tile`` (any n, m, D; exact f32)."""
    from .precision import full_f32

    with full_f32():
        g = x @ z.T
    nx = torch.sum(x * x, dim=1)
    nz = torch.sum(z * z, dim=1)
    d2 = torch.clamp(nx[:, None] + nz[None, :] - 2.0 * g, min=0.0)
    if symmetric:
        d2.diagonal().zero_()
    return _apply_map(family, d2, params)


def _params_buffer(params, device) -> torch.Tensor:
    if not params:
        return torch.zeros(1, dtype=torch.float32, device=device)
    return torch.stack([torch.as_tensor(p).detach().reshape(())
                        .to(torch.float32) for p in params]).to(device)


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


class _FusedGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, family, symmetric, x, z, *params):
        return gram_tile(x, z, family, params, symmetric)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the fused gram backward (Pallas _bwd_pass, kernel #6) is not ported "
            "yet: ROADMAP.md queue 2 item 6"
        )


def fused_isotropic_gram(kernel, x: torch.Tensor, z: torch.Tensor,
                         symmetric: bool = False) -> torch.Tensor:
    """Fused gram of an isotropic kernel (its ``FAMILY`` and ``_map_params``)
    between the rows of x and z."""
    return _FusedGram.apply(kernel.FAMILY, symmetric, x, z, *kernel._map_params())
