"""Pairwise-distance primitives (the gram-matrix inner loop) and the
package's device policy.

Inputs are canonicalised to shape (N, D): a 1-D array of N scalars becomes
(N, 1), as in the JAX package's ``ops/distance.py``.

Device policy: a tensor keeps the device it lives on. Anything else
(numpy arrays, lists, Python scalars) is converted onto the package's
default device, which is ``"cuda"`` unless the caller sets another with
``set_default_device`` (the CPU tests set ``"cpu"``). With no card present
a conversion onto ``"cuda"`` raises; it never carries on on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "as_inputs",
    "as_tensor",
    "col_vecs",
    "row_vecs",
    "pairwise_sqdist",
    "sq_norms",
    "safe_sqrt",
    "set_default_device",
    "get_default_device",
]

_DEFAULT_DEVICE = torch.device("cuda")


def set_default_device(device) -> None:
    """Device that non-tensor inputs are converted onto."""
    global _DEFAULT_DEVICE
    _DEFAULT_DEVICE = torch.device(device)


def get_default_device() -> torch.device:
    return _DEFAULT_DEVICE


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """A tensor as it is (cast to ``dtype``/``device`` only when given), or
    a non-tensor converted onto the default device."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype or x.dtype, device=device or x.device)
    device = torch.device(device) if device is not None else _DEFAULT_DEVICE
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "abstractgps_tpu_torch converts inputs onto 'cuda' by default and "
            "no CUDA device is available; call set_default_device('cpu') or "
            "pass tensors"
        )
    arr = np.asarray(x)
    if dtype is None and arr.dtype.kind in "iub":
        arr = arr.astype(np.float64)
    return torch.as_tensor(arr, dtype=dtype, device=device)


def as_inputs(x, obsdim: int | None = None) -> torch.Tensor:
    """Canonicalise inputs to a (N, D) tensor.

    - 1-D array of N scalars → (N, 1)
    - 2-D array: rows are observations by default. ``obsdim=2`` (Julia
      convention: observations along columns / ColVecs) transposes.
    """
    x = as_tensor(x)
    if x.ndim == 0:
        return x.reshape(1, 1)
    if x.ndim == 1:
        return x[:, None]
    if x.ndim == 2:
        return x.T if obsdim == 2 else x
    raise ValueError(f"inputs must be 1-D or 2-D, got ndim={x.ndim}")


def col_vecs(X) -> torch.Tensor:
    """ColVecs(X): observations are the *columns* of X → (N, D)."""
    return as_tensor(X).T


def row_vecs(X) -> torch.Tensor:
    """RowVecs(X): observations are the *rows* of X → (N, D)."""
    return as_tensor(X)


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared norms of an (N, D) tensor."""
    return torch.sum(x * x, dim=-1)


def pairwise_sqdist(x, z=None) -> torch.Tensor:
    """Pairwise squared Euclidean distances between rows of x and z.

    ``‖x‖² + ‖z‖² − 2·x·zᵀ`` with the product at IEEE f32 (never TF32: the
    expansion is cancellation-prone), clamped at 0. For the symmetric case
    (z is None) the diagonal is exactly zero.
    """
    from .precision import full_f32

    x = as_inputs(x)
    with full_f32():
        if z is None:
            g = x @ x.T
            nx = torch.diagonal(g)
            d2 = torch.clamp(nx[:, None] + nx[None, :] - 2.0 * g, min=0.0)
            d2.diagonal().zero_()
            return d2
        z = as_inputs(z)
        d2 = sq_norms(x)[:, None] + sq_norms(z)[None, :] - 2.0 * (x @ z.T)
    return torch.clamp(d2, min=0.0)


def safe_sqrt(d2: torch.Tensor) -> torch.Tensor:
    """sqrt with a finite gradient at 0 (the primal there is exactly 0)."""
    pos = d2 > 0.0
    safe = torch.where(pos, d2, torch.ones_like(d2))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(d2))
