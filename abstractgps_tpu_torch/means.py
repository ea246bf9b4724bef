"""Mean functions (reference: src/mean_function.jl:1-55).

``mean_vector(m, x)`` evaluates a mean function over a batch of inputs
(shape (N,) or (N, D)) and returns an (N,) vector. Means are
``nn.Module``s; ``ConstMean.c`` is an ``nn.Parameter``.
"""

from __future__ import annotations

import torch
from torch import nn

from .ops.distance import as_inputs, as_tensor

__all__ = ["ZeroMean", "ConstMean", "CustomMean", "mean_vector", "as_mean"]


def as_param(v) -> torch.Tensor:
    """A hyperparameter. A tensor that requires grad (the caller's own, or
    one computed from it) is kept as it is, so autograd flows back to the
    caller; another tensor becomes an ``nn.Parameter`` of its dtype and
    device; a Python or numpy number becomes a CPU float64 ``nn.Parameter``
    (the JAX package's x64 ``jnp.asarray(v, float)``)."""
    if isinstance(v, (str, bytes)):
        raise TypeError(
            f"kernel/mean parameter must be numeric, got {type(v).__name__}: {v!r}"
        )
    if isinstance(v, torch.Tensor):
        if v.requires_grad:
            return v
        return nn.Parameter(v if v.is_floating_point() else v.to(torch.float64))
    return nn.Parameter(torch.as_tensor(v, dtype=torch.float64))


class ZeroMean(nn.Module):
    """Zero everywhere."""

    def forward(self, x) -> torch.Tensor:
        x = as_inputs(x)
        dtype = x.dtype if x.is_floating_point() else torch.float64
        return torch.zeros((x.shape[0],), dtype=dtype, device=x.device)


class ConstMean(nn.Module):
    """Constant c everywhere."""

    def __init__(self, c):
        super().__init__()
        self.c = as_param(c)

    def forward(self, x) -> torch.Tensor:
        x = as_inputs(x)
        dtype = x.dtype if x.is_floating_point() else self.c.dtype
        return self.c.to(device=x.device, dtype=dtype).expand(x.shape[0])


class CustomMean(nn.Module):
    """Arbitrary mean function.

    ``fn`` is treated as a per-point function of a single input (scalar for
    1-D inputs, a (D,) vector otherwise) and mapped over the batch with
    ``torch.func.vmap``; set ``batched=True`` if ``fn`` already maps an
    (N, D) batch to (N,). ``params`` (a module, tensor or None) is passed as
    ``fn(params, x)`` when not None.
    """

    def __init__(self, fn, params=None, batched: bool = False):
        super().__init__()
        self.fn = fn
        self.params = params
        self.batched = batched

    def _eval(self, x):
        if self.params is None:
            return self.fn(x)
        return self.fn(self.params, x)

    def forward(self, x) -> torch.Tensor:
        x = as_tensor(x)
        if self.batched:
            out = self._eval(x)
        elif x.ndim <= 1:
            out = torch.func.vmap(self._eval)(x)
        else:
            out = torch.func.vmap(self._eval)(as_inputs(x))
        return torch.reshape(out, (-1,))


def mean_vector(m, x) -> torch.Tensor:
    """Evaluate a mean function over inputs (reference ``mean_vector``)."""
    return m(x)


def as_mean(m):
    """``None``→ZeroMean, real→ConstMean, callable→CustomMean, or pass
    through."""
    if m is None:
        return ZeroMean()
    if isinstance(m, (ZeroMean, ConstMean, CustomMean)):
        return m
    if callable(m) and not isinstance(m, (int, float)):
        return CustomMean(m)
    return ConstMean(m)
