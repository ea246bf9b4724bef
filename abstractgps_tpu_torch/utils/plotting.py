"""Plotting parity layer (matplotlib).

Counterpart of the JAX package's ``utils/plotting.py`` (reference: the
Plots.jl recipes at src/util/plotting.jl:1-132): ``plot_gp`` draws the mean
with a ``ribbon_scale``·std ribbon from ``marginals()``; ``sampleplot``
draws joint samples flattened into one NaN-separated series, with 1e-9
jitter for a bare GP. matplotlib is imported inside the functions only, so
the package imports without it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["plot_gp", "sampleplot"]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _project(fx_or_f, x):
    """A FiniteGP as it is, or a bare AbstractGP projected at ``x``."""
    from ..models.finite_gp import FiniteGP
    from ..models.gp import AbstractGP

    if isinstance(fx_or_f, FiniteGP):
        return fx_or_f
    if isinstance(fx_or_f, AbstractGP):
        if x is None:
            raise ValueError("plotting a bare GP requires x")
        # a bare AbstractGP gets 1e-9 jitter (src/util/plotting.jl:118)
        return fx_or_f(x, 1e-9)
    raise TypeError(f"cannot plot {type(fx_or_f)!r}")


def _first_dim(fx) -> np.ndarray:
    xs = _np(fx.x)
    return xs[:, 0] if xs.ndim == 2 else xs


def plot_gp(fx, x=None, *, ax=None, ribbon_scale: float = 1.0, color="C0", label=None,
            **line_kwargs):
    """Mean ± ``ribbon_scale``·std ribbon (src/util/plotting.jl:3-16), against
    the first input dimension. ``fx`` is a FiniteGP, or a bare GP with ``x``."""
    import matplotlib.pyplot as plt

    if ribbon_scale < 0:
        raise ValueError("ribbon_scale must be non-negative")
    fx = _project(fx, x)
    xs = _first_dim(fx)
    order = np.argsort(xs)
    m, s = (_np(a) for a in fx.marginals())
    if ax is None:
        ax = plt.gca()
    ax.plot(xs[order], m[order], color=color, label=label, **line_kwargs)
    ax.fill_between(xs[order], (m - ribbon_scale * s)[order], (m + ribbon_scale * s)[order],
                    color=color, alpha=0.3, linewidth=0)
    return ax


def sampleplot(fx, x=None, *, generator=None, samples: int = 1, ax=None, color="C0",
               alpha=0.35, **line_kwargs):
    """``samples`` joint samples as one NaN-separated line
    (src/util/plotting.jl:104-132); ``generator`` is a ``torch.Generator``
    or an int seed (None: 0) on the inputs' device."""
    import matplotlib.pyplot as plt

    fx = _project(fx, x)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=fx.x.device).manual_seed(int(generator or 0))
    xs = _first_dim(fx)
    order = np.argsort(xs)
    S = _np(fx.rand(generator, samples))  # (N, samples)
    x_flat = np.concatenate([np.append(xs[order], np.nan) for _ in range(samples)])
    y_flat = np.concatenate([np.append(S[order, j], np.nan) for j in range(samples)])
    if ax is None:
        ax = plt.gca()
    ax.plot(x_flat, y_flat, color=color, alpha=alpha, **line_kwargs)
    return ax
