"""Utilities: plotting, conformance suites, checkpointing, debugging,
profiling. ``plot_gp``/``sampleplot`` import matplotlib only when called."""

from . import checkpoint, debug, profiling, test_utils
from .plotting import plot_gp, sampleplot

__all__ = ["plot_gp", "sampleplot", "test_utils", "checkpoint", "profiling", "debug"]
