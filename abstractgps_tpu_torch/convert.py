"""Carry kernel, mean and noise weights across from a plain description.

The input is a nested dict of class names and numpy leaves, e.g.::

    {"type": "ScaledKernel", "variance": array(1.3),
     "kernel": {"type": "TransformedKernel",
                "transform": {"type": "ScaleTransform", "s": array(1.25)},
                "kernel": {"type": "Matern32Kernel"}}}

Field names are those of the kernel classes' constructors (which match the
JAX package's dataclass fields); a sum or product carries its parts as a
list under ``"kernels"``. Array leaves become tensors of the given dtype on
the given device; integers (``PolynomialKernel.degree``) stay integers.
``FunctionTransform`` and ``CustomMean`` carry code, not weights, and are
refused.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels as _kernels
from .kernels import base as _base
from .means import ConstMean, ZeroMean
from .ops.noise import DenseNoise, DiagonalNoise, IsotropicNoise

__all__ = ["kernel_from_numpy", "mean_from_numpy", "noise_from_numpy"]

_TRANSFORMS = {
    "ScaleTransform": _base.ScaleTransform,
    "ARDTransform": _base.ARDTransform,
    "LinearTransform": _base.LinearTransform,
}
_INT_FIELDS = {"degree"}


def _leaf(v, dtype, device):
    return torch.tensor(np.asarray(v), dtype=dtype, device=device)


def _build(tree, dtype, device):
    name = tree["type"]
    fields = {k: v for k, v in tree.items() if k != "type"}
    if name in ("KernelSum", "KernelProduct"):
        parts = [_build(t, dtype, device) for t in fields["kernels"]]
        return getattr(_base, name)(parts)
    if name in _TRANSFORMS:
        return _TRANSFORMS[name](*(_leaf(v, dtype, device) for v in fields.values()))
    if name in ("ScaledKernel", "TransformedKernel"):
        inner = _build(fields["kernel"], dtype, device)
        if name == "ScaledKernel":
            return _base.ScaledKernel(inner, _leaf(fields["variance"], dtype, device))
        return _base.TransformedKernel(inner, _build(fields["transform"], dtype, device))
    cls = getattr(_kernels, name, None)
    if not (isinstance(cls, type) and issubclass(cls, _base.Kernel)):
        raise ValueError(f"cannot carry across {name!r}")
    kwargs = {k: (int(v) if k in _INT_FIELDS else _leaf(v, dtype, device))
              for k, v in fields.items()}
    return cls(**kwargs)


def kernel_from_numpy(tree: dict, device="cpu", dtype=torch.float64) -> _base.Kernel:
    """The port's kernel module tree for a nested-dict description."""
    return _build(tree, dtype, torch.device(device))


def mean_from_numpy(tree: dict, device="cpu", dtype=torch.float64):
    """``{"type": "ZeroMean"}`` or ``{"type": "ConstMean", "c": array}``."""
    if tree["type"] == "ZeroMean":
        return ZeroMean()
    if tree["type"] == "ConstMean":
        return ConstMean(_leaf(tree["c"], dtype, torch.device(device)))
    raise ValueError(f"cannot carry across {tree['type']!r}")


def noise_from_numpy(tree: dict, device="cpu", dtype=torch.float64):
    """``{"type": "IsotropicNoise", "variance": a, "n": n}``,
    ``{"type": "DiagonalNoise", "variances": v}`` or
    ``{"type": "DenseNoise", "cov": C}``."""
    device = torch.device(device)
    kind = tree["type"]
    if kind == "IsotropicNoise":
        return IsotropicNoise(_leaf(tree["variance"], dtype, device), int(tree["n"]))
    if kind == "DiagonalNoise":
        return DiagonalNoise(_leaf(tree["variances"], dtype, device))
    if kind == "DenseNoise":
        return DenseNoise(_leaf(tree["cov"], dtype, device))
    raise ValueError(f"cannot carry across {kind!r}")
