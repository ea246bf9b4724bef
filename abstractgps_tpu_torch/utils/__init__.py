"""Utilities: the conformance suites of the GP interface tiers."""

from . import test_utils

__all__ = ["test_utils"]
