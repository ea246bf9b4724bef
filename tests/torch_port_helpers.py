"""Shared helpers of the tests that hold abstractgps_tpu_torch against the
JAX package: the JAX-kernel → nested-dict walker (the port cannot import
JAX, so this lives on the test side), small-size patches of both packages'
gates, SPD test matrices, and the replay of a JAX call's random draws
through the port's draws objects."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from abstractgps_tpu.ops import pallas_chol, pallas_gram
from abstractgps_tpu_torch.ops import blocked_chol, distance, fused_gram

# the interpret-mode sizes: 64-wide slabs of 16-wide blocks, fused paths
# from n = 32, wide solves from 16 right-hand sides, fused gram from 32²
SMALL = {"_MIN_N": 32, "_BLOCK": 16, "_OUTER": 64, "_WIDE_RHS": 16}
SMALL_GRAM = 32 * 32


def kernel_tree(k) -> dict:
    """Nested dict of class names and numpy leaves for a JAX kernel."""
    out = {"type": type(k).__name__}
    for f in dataclasses.fields(k):
        v = getattr(k, f.name)
        if f.name == "kernels":
            out[f.name] = [kernel_tree(c) for c in v]
        elif dataclasses.is_dataclass(v):
            out[f.name] = kernel_tree(v)
        elif isinstance(v, int):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


@contextlib.contextmanager
def small_kernel_paths():
    """Both packages in interpret mode with the small sizes above."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))
        for mod in (pallas_chol, pallas_gram, blocked_chol, fused_gram):
            mp.setattr(mod, "_INTERPRET", True)
        for name, value in SMALL.items():
            mp.setattr(pallas_chol, name, value)
            mp.setattr(blocked_chol, name, value)
        mp.setattr(pallas_gram, "_MIN_SIZE", SMALL_GRAM)
        mp.setattr(fused_gram, "_MIN_SIZE", SMALL_GRAM)
        yield mp


def spd(rng, n):
    """A well-conditioned SPD matrix (float64 numpy)."""
    X = rng.normal(size=(n, n + 8))
    return X @ X.T / (n + 8) + 0.5 * np.eye(n)


def mlp_weights(rng, sizes=(1, 16, 16, 2)):
    """numpy weights of a tanh MLP, ``[(w, b), ...]`` (w scaled by
    √(2/fan-in), as ``examples/deep_kernel_learning.py:mlp_init``; b small
    and nonzero, so its gradient is exercised)."""
    return [(rng.normal(size=(kin, kout)) * np.sqrt(2.0 / kin), 0.1 * rng.normal(size=kout))
            for kin, kout in zip(sizes[:-1], sizes[1:])]


def mlp_trees(weights, dtype=np.float32):
    """The same MLP weights as a JAX parameter tree and as a torch one: each a
    list of ``{"w", "b"}`` dicts, the deep-kernel example's layout. The torch
    leaves require grad."""
    import jax.numpy as jnp

    jax_tree = [{"w": jnp.asarray(w.astype(dtype)), "b": jnp.asarray(b.astype(dtype))}
                for w, b in weights]
    torch_tree = [{"w": torch.as_tensor(w.astype(dtype)).requires_grad_(),
                   "b": torch.as_tensor(b.astype(dtype)).requires_grad_()}
                  for w, b in weights]
    return jax_tree, torch_tree


def mlp_apply(params, x):
    """The deep-kernel example's feature map (tanh hidden layers, linear
    output); works on JAX and torch arrays alike."""
    import jax.numpy as jnp

    tanh = torch.tanh if isinstance(x, torch.Tensor) else jnp.tanh
    h = x
    for layer in params[:-1]:
        h = tanh(h @ layer["w"] + layer["b"])
    return h @ params[-1]["w"] + params[-1]["b"]


def param_tree(tree):
    """Nested description of a tagged JAX parameter tree (``Positive.raw``,
    ``Bounded.raw/lo/hi``, ``Fixed.val``, plain arrays) for
    ``abstractgps_tpu_torch.params_from_numpy``."""
    from abstractgps_tpu import params as P

    if isinstance(tree, P.Positive):
        return {"type": "Positive", "raw": np.asarray(tree.raw)}
    if isinstance(tree, P.Bounded):
        return {"type": "Bounded", "raw": np.asarray(tree.raw), "lo": tree.lo, "hi": tree.hi}
    if isinstance(tree, P.Fixed):
        return {"type": "Fixed", "val": tree.val}
    if isinstance(tree, dict):
        return {k: param_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(param_tree(v) for v in tree)
    return np.asarray(tree)


_DRAW_KINDS = ("normal", "uniform", "gamma", "rademacher")


@contextlib.contextmanager
def record_jax_draws():
    """Within the block, every ``jax.random.{normal, uniform, gamma,
    rademacher}`` call is recorded, in call order, as (kind, numpy array).
    Run the JAX function eagerly inside (under ``jax.jit`` the draws are
    tracers). Yields the list."""
    import jax

    records = []
    with pytest.MonkeyPatch.context() as mp:
        for kind in _DRAW_KINDS:
            orig = getattr(jax.random, kind)

            def rec(*a, _orig=orig, _kind=kind, **k):
                out = _orig(*a, **k)
                records.append((_kind, np.asarray(out)))
                return out

            mp.setattr(jax.random, kind, rec)
        yield records


class JaxDraws:
    """A draws object (``abstractgps_tpu_torch.ops.draws``) that hands out the
    recorded JAX draws in order, checking each site's kind and shape, so the
    port runs the JAX package's estimator on the JAX package's numbers."""

    def __init__(self, records):
        self.records = list(records)

    def _next(self, kind, shape, dtype, device):
        got, arr = self.records.pop(0)
        assert (got, arr.shape) == (kind, tuple(shape)), (got, arr.shape, kind, shape)
        return torch.as_tensor(np.array(arr), dtype=dtype, device=device)

    def normal(self, shape, dtype, device):
        return self._next("normal", shape, dtype, device)

    def uniform(self, shape, high, dtype, device):
        return self._next("uniform", shape, dtype, device)

    def gamma(self, concentration, shape, dtype, device):
        return self._next("gamma", shape, dtype, device)

    def rademacher(self, shape, dtype, device):
        return self._next("rademacher", shape, dtype, device)
