"""Tracing and roofline accounting.

Counterpart of the JAX package's ``utils/profiling.py``: ``trace`` wraps
``torch.profiler`` and writes a Chrome trace; ``timed`` measures a block's
wall time with a device sync at its end; ``roofline`` turns a measured
time into achieved FLOP/s and a fraction of the card's peak for the two GP
hot ops.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch

__all__ = ["trace", "timed", "roofline", "Roofline", "gram_flops", "cholesky_flops",
           "H100_PEAK_F32"]

# the FP32 (non-tensor-core) peak of one H100 SXM from NVIDIA's datasheet,
# 67 TFLOP/s: a published figure, not a measurement
H100_PEAK_F32 = 67e12


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace("prof"): ...`` → ``prof/trace.json``, a Chrome trace of
    the block (CPU ops, and the card's kernels when CUDA is available)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def timed(out: dict, key: str = "seconds"):
    """Measure a block's wall time into ``out[key]``, synchronising the
    current CUDA device at the end (nothing more on the CPU)."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    out[key] = time.perf_counter() - t0


def gram_flops(n: int, m: int, d: int) -> float:
    """FLOPs of an (n×m) gram tile over d dims: the 2·n·m·d distance
    contraction dominates (the elementwise map is O(n·m))."""
    return 2.0 * n * m * d


def cholesky_flops(n: int) -> float:
    """N³/3 FLOPs (the standard convention)."""
    return n ** 3 / 3.0


@dataclass
class Roofline:
    seconds: float
    flops: float
    achieved: float       # FLOP/s
    peak: float
    fraction_of_peak: float

    def __str__(self):
        return (f"{self.achieved / 1e12:.2f} TFLOP/s "
                f"({100 * self.fraction_of_peak:.1f}% of "
                f"{self.peak / 1e12:.0f} TFLOP/s roof)")


def roofline(flops: float, seconds: float, peak: float = H100_PEAK_F32) -> Roofline:
    achieved = flops / seconds
    return Roofline(seconds, flops, achieved, peak, achieved / peak)
