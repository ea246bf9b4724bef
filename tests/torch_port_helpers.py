"""Shared helpers of the tests that hold abstractgps_tpu_torch against the
JAX package: the JAX-kernel → nested-dict walker (the port cannot import
JAX, so this lives on the test side), small-size patches of both packages'
gates, and SPD test matrices."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

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
