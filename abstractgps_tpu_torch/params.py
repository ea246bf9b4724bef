"""Constrained-parameter handling (the ParameterHandling.jl analogue).

Counterpart of the JAX package's ``params.py``. Hyperparameters live in
nested dicts, lists or tuples whose leaves are tagged with bijectors:
``positive`` (softplus), ``bounded`` (scaled logistic), ``fixed`` (no
trainable leaf) or ``real`` (the tensor itself). A tagged leaf holds its
unconstrained ``raw`` tensor, which requires grad; ``constrain`` maps a tree
to its model-space values (still in the autograd graph), ``leaves`` lists
the raw tensors an optimizer updates, and ``ravel`` gives a flat vector and
its ``unravel``. Dict keys are visited in sorted order, as JAX's pytrees
visit them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "Positive",
    "Bounded",
    "Fixed",
    "positive",
    "bounded",
    "fixed",
    "real",
    "constrain",
    "unconstrain",
    "leaves",
    "with_leaves",
    "ravel",
    "softplus",
    "inv_softplus",
]


def softplus(x):
    """Numerically stable log(1 + exp(x))."""
    x = torch.as_tensor(x)
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y):
    """Inverse of softplus: log(exp(y) − 1), stable for large y."""
    y = torch.as_tensor(y)
    return y + torch.log(-torch.expm1(-y))


def _float_tensor(value) -> torch.Tensor:
    """A tensor keeps its floating dtype; a Python number or list becomes
    float64 (the JAX package's x64 ``jnp.result_type(value, float)``)."""
    if isinstance(value, torch.Tensor):
        return value if value.is_floating_point() else value.to(torch.float64)
    arr = np.asarray(value)
    return torch.as_tensor(arr if arr.dtype.kind == "f" else arr.astype(np.float64))


@dataclasses.dataclass(frozen=True)
class Positive:
    """Positive-constrained parameter, stored unconstrained (softplus)."""

    raw: torch.Tensor

    @property
    def value(self):
        return softplus(self.raw)


@dataclasses.dataclass(frozen=True)
class Bounded:
    """(lo, hi)-bounded parameter via a scaled logistic."""

    raw: torch.Tensor
    lo: float
    hi: float

    @property
    def value(self):
        return self.lo + (self.hi - self.lo) * torch.sigmoid(self.raw)


@dataclasses.dataclass(frozen=True)
class Fixed:
    """Non-trainable constant: contributes no leaves."""

    val: object

    @property
    def value(self):
        return torch.as_tensor(self.val)


_TAGS = (Positive, Bounded, Fixed)


def positive(value) -> Positive:
    """Tag a positive value; round-trips: constrain(positive(v)) == v."""
    return Positive(inv_softplus(_float_tensor(value)).detach().requires_grad_())


def bounded(value, lo: float, hi: float) -> Bounded:
    v = _float_tensor(value)
    p = (v - lo) / (hi - lo)
    return Bounded((torch.log(p) - torch.log1p(-p)).detach().requires_grad_(), lo, hi)


def fixed(value) -> Fixed:
    return Fixed(value)


def real(value) -> torch.Tensor:
    """Unconstrained parameter — the tensor itself, requiring grad."""
    return _float_tensor(value).detach().clone().requires_grad_()


def _map(fn, tree):
    """Apply ``fn`` to every tagged leaf and tensor of a nested tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def constrain(tree):
    """Replace every tagged leaf by its constrained value: a tree of
    tensors ready to build kernels and GPs."""
    return _map(lambda p: p.value if isinstance(p, _TAGS) else p, tree)


def unconstrain(tree):
    """The optimisation-space tree: tagged leaves expose their raw tensors,
    Fixed leaves hold none."""
    return tree


def leaves(tree) -> list:
    """The trainable raw tensors of a tree, in pytree order (sorted dict
    keys); Fixed leaves and non-tensors contribute none."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(leaves(tree[k]))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out.extend(leaves(v))
    elif isinstance(tree, (Positive, Bounded)):
        out.append(tree.raw)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    if isinstance(tree, (Positive, Bounded)):
        return dataclasses.replace(tree, raw=next(it))
    if isinstance(tree, torch.Tensor):
        return next(it)
    return tree


def with_leaves(tree, new_leaves):
    """The tree with its trainable leaves replaced, in ``leaves`` order."""
    return _rebuild(tree, iter(new_leaves))


def ravel(tree):
    """Flatten a (possibly tagged) parameter tree to a flat vector and an
    ``unravel`` that maps such a vector back to a tree of the same shape
    (the ``value_flatten`` pattern)."""
    ls = leaves(tree)
    shapes = [t.shape for t in ls]
    flat = torch.cat([t.reshape(-1) for t in ls]) if ls else torch.zeros(0)

    def unravel(v):
        parts, i = [], 0
        for shp in shapes:
            k = shp.numel()
            parts.append(v[i:i + k].reshape(shp))
            i += k
        return with_leaves(tree, parts)

    return flat, unravel
