"""Carry kernel, mean and noise weights across from a plain description.

The input is a nested dict of class names and numpy leaves, e.g.::

    {"type": "ScaledKernel", "variance": array(1.3),
     "kernel": {"type": "TransformedKernel",
                "transform": {"type": "ScaleTransform", "s": array(1.25)},
                "kernel": {"type": "Matern32Kernel"}}}

Field names are those of the kernel classes' constructors (which match the
JAX package's dataclass fields); a sum or product carries its parts as a
list under ``"kernels"``. Array leaves become tensors of the given dtype on
the given device, by default the package's default device (``"cuda"``
unless ``set_default_device`` says otherwise; with no card present that
raises, as ``as_tensor`` does); integers (``PolynomialKernel.degree``)
stay integers. ``FunctionTransform`` and ``CustomMean`` carry code, not
weights, and are refused.

A tagged parameter tree (``params``) is carried across by
``params_from_numpy``: nested dicts, lists and tuples whose leaves are
``{"type": "Positive", "raw": a}``, ``{"type": "Bounded", "raw": a, "lo":
lo, "hi": hi}``, ``{"type": "Fixed", "val": v}`` or plain arrays.

Model states are carried across by ``svgp_from_numpy`` (an ``SVGP``'s
kernel and mean descriptions and its z, m, C_raw and jitter arrays),
``online_from_numpy`` (an ``OnlineGP`` cache of a GP prior),
``cg_posterior_from_numpy`` (a ``CGPosteriorGP``: its prior, cache arrays
and solver settings) and ``fourier_features_from_numpy`` (the random
features of a pathwise sample). A sparse posterior carries nothing beyond
its kernel, noise and inducing inputs, which the converters above cover.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels as _kernels
from . import params as _params
from .kernels import base as _base
from .means import ConstMean, ZeroMean
from .ops.distance import resolve_device
from .ops.noise import DenseNoise, DiagonalNoise, IsotropicNoise

__all__ = ["kernel_from_numpy", "mean_from_numpy", "noise_from_numpy", "params_from_numpy",
           "svgp_from_numpy", "online_from_numpy", "cg_posterior_from_numpy",
           "fourier_features_from_numpy"]

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
        return _transform(tree, dtype, device)
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


def _transform(tree, dtype, device):
    if tree["type"] not in _TRANSFORMS:
        raise ValueError(f"cannot carry across {tree['type']!r}")
    return _TRANSFORMS[tree["type"]](*(_leaf(v, dtype, device)
                                       for k, v in tree.items() if k != "type"))


def kernel_from_numpy(tree: dict, device=None, dtype=torch.float64) -> _base.Kernel:
    """The port's kernel module tree for a nested-dict description."""
    return _build(tree, dtype, resolve_device(device))


def mean_from_numpy(tree: dict, device=None, dtype=torch.float64):
    """``{"type": "ZeroMean"}`` or ``{"type": "ConstMean", "c": array}``."""
    if tree["type"] == "ZeroMean":
        return ZeroMean()
    if tree["type"] == "ConstMean":
        return ConstMean(_leaf(tree["c"], dtype, resolve_device(device)))
    raise ValueError(f"cannot carry across {tree['type']!r}")


def noise_from_numpy(tree: dict, device=None, dtype=torch.float64):
    """``{"type": "IsotropicNoise", "variance": a, "n": n}``,
    ``{"type": "DiagonalNoise", "variances": v}`` or
    ``{"type": "DenseNoise", "cov": C}``."""
    device = resolve_device(device)
    kind = tree["type"]
    if kind == "IsotropicNoise":
        return IsotropicNoise(_leaf(tree["variance"], dtype, device), int(tree["n"]))
    if kind == "DiagonalNoise":
        return DiagonalNoise(_leaf(tree["variances"], dtype, device))
    if kind == "DenseNoise":
        return DenseNoise(_leaf(tree["cov"], dtype, device))
    raise ValueError(f"cannot carry across {kind!r}")


def params_from_numpy(tree, device=None, dtype=torch.float64):
    """The port's tagged parameter tree for a nested description (see the
    module docstring); raw tensors and plain arrays become leaves that
    require grad."""
    device = resolve_device(device)
    if isinstance(tree, dict) and tree.get("type") in ("Positive", "Bounded", "Fixed"):
        kind = tree["type"]
        if kind == "Fixed":
            return _params.Fixed(tree["val"])
        raw = _leaf(tree["raw"], dtype, device).requires_grad_()
        if kind == "Positive":
            return _params.Positive(raw)
        return _params.Bounded(raw, float(tree["lo"]), float(tree["hi"]))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    return _leaf(tree, dtype, device).requires_grad_()


def svgp_from_numpy(tree: dict, device=None, dtype=torch.float64):
    """The port's ``SVGP`` for ``{"kernel": k, "mean": mu, "z": z, "m": m,
    "C_raw": C_raw, "jitter": j}``: ``k`` and ``mu`` as ``kernel_from_numpy``
    and ``mean_from_numpy`` take them, the rest numpy arrays."""
    from .models.svgp import SVGP

    device = resolve_device(device)
    return SVGP(mean_from_numpy(tree["mean"], device, dtype),
                kernel_from_numpy(tree["kernel"], device, dtype),
                *(_leaf(tree[k], dtype, device) for k in ("z", "m", "C_raw", "jitter")))


def online_from_numpy(tree: dict, device=None, dtype=torch.float64):
    """The port's ``OnlineGP`` for ``{"prior": {"kernel": k, "mean": mu},
    "L": L, "alpha": a, "delta": d, "x": x, "count": c}``: the prior a
    ``GP(mean, kernel)``, the cache numpy arrays, ``count`` an integer."""
    from .models.online import OnlineGP

    device = resolve_device(device)
    prior = _gp_prior(tree["prior"], device, dtype)
    return OnlineGP(prior, *(_leaf(tree[k], dtype, device) for k in ("L", "alpha", "delta", "x")),
                    torch.tensor(int(tree["count"]), dtype=torch.int64, device=device))


def _gp_prior(tree: dict, device, dtype):
    from .models.gp import GP

    return GP(mean_from_numpy(tree["mean"], device, dtype),
              kernel_from_numpy(tree["kernel"], device, dtype))


def cg_posterior_from_numpy(tree: dict, device=None, dtype=torch.float64):
    """The port's ``CGPosteriorGP`` for ``{"prior": {"kernel": k, "mean": mu},
    "x": x, "noise_diag": nd, "alpha": a, "Lk": L or None, "max_iters": t,
    "tol": tol or None, "panel": p, "max_dense_n": n, "precond_rank": r}``:
    the arrays numpy, the settings plain numbers."""
    from .models.iterative import CGPosteriorGP

    device = resolve_device(device)
    arrays = {k: None if tree[k] is None else _leaf(tree[k], dtype, device)
              for k in ("x", "noise_diag", "alpha", "Lk")}
    tol = tree["tol"]
    return CGPosteriorGP(
        prior=_gp_prior(tree["prior"], device, dtype), **arrays,
        max_iters=int(tree["max_iters"]), tol=None if tol is None else float(tol),
        panel=int(tree["panel"]), max_dense_n=int(tree["max_dense_n"]),
        precond_rank=int(tree["precond_rank"]))


def fourier_features_from_numpy(tree: dict, device=None, dtype=torch.float64):
    """The port's random-feature map for ``{"omega": w, "bias": b, "weights":
    a, "transforms": [t, ...]}`` (a ``FourierFeatures``) or ``{"blocks":
    [...], "transforms": [t, ...]}`` (the per-addend concatenation of a sum
    kernel): the arrays numpy, each transform a Scale/ARD/Linear
    description as ``kernel_from_numpy`` takes them."""
    from .models import pathwise

    device = resolve_device(device)
    transforms = tuple(_transform(t, dtype, device) for t in tree["transforms"])
    if "blocks" in tree:
        return pathwise._ConcatFeatures(
            tuple(fourier_features_from_numpy(b, device, dtype) for b in tree["blocks"]),
            transforms)
    return pathwise.FourierFeatures(*(_leaf(tree[k], dtype, device)
                                      for k in ("omega", "bias", "weights")), transforms)
