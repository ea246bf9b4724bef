"""Matmul precision policy for numerical stability on the GPU.

The JAX package's "high" policy runs f32 matmuls as bf16x3 passes, which
is f32-quality. On an NVIDIA card the quality-preserving mapping is full
IEEE f32, NOT TF32: TF32 keeps a 10-bit mantissa, the same hazard the JAX
package documents for single-pass bf16 (corrupted Cholesky pivots and
negative posterior variances). Note that
``torch.set_float32_matmul_precision("high")`` means TF32 — the policy is
mapped by accuracy, not by name:

    policy      torch.backends.cuda.matmul.allow_tf32 / cudnn.allow_tf32
    "default"   True  (TF32 allowed; only the non-critical matmuls)
    "high"      False (IEEE f32)
    "highest"   False (IEEE f32)

``precise`` applies the policy for the scope of one call and restores the
flags afterwards. The cancellation-prone primitives (the Cholesky panel
GEMMs of ``ops.blocked_chol``) floor themselves at IEEE f32 even under the
"default" policy via ``full_f32``.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_PRECISION = "high"

__all__ = [
    "precise",
    "full_f32",
    "set_matmul_precision",
    "get_matmul_precision",
]


def set_matmul_precision(precision: str) -> None:
    """Set the library-wide matmul precision: "default" | "high" | "highest"."""
    global _PRECISION
    if precision not in ("default", "high", "highest"):
        raise ValueError(f"unknown precision {precision!r}")
    _PRECISION = precision


def get_matmul_precision() -> str:
    return _PRECISION


@contextlib.contextmanager
def _tf32(allowed: bool):
    cuda_prev = torch.backends.cuda.matmul.allow_tf32
    cudnn_prev = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allowed
    torch.backends.cudnn.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda_prev
        torch.backends.cudnn.allow_tf32 = cudnn_prev


def full_f32():
    """Scope in which f32 matmuls run at IEEE f32 whatever the policy."""
    return _tf32(False)


def precise(fn):
    """Run ``fn`` under the library's matmul-precision policy."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _tf32(_PRECISION == "default"):
            return fn(*args, **kwargs)

    return wrapped
