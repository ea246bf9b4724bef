"""Test-mode sanitizers: NaN trapping and a non-finite guard.

Counterpart of the JAX package's ``utils/debug.py``:

- ``debug_mode()`` raises ``FloatingPointError`` at the first torch op
  whose floating output holds a NaN (what ``jax_debug_nans`` raises), by a
  ``TorchDispatchMode`` that reads every op's output, and turns on
  autograd's anomaly mode with its NaN check for backwards. The factory
  and fill ops are skipped: the output of ``empty`` and its kin is
  uninitialised by design, and a NaN that ``full`` and its kin write is
  written on purpose (the NaN-for-failure factor of
  ``covmat._cholesky_nan``, which a ``where`` then drops). The CUDA kernels launched through ``ctypes`` are invisible to
  a dispatch mode; a NaN they write is caught at the next torch op that
  reads it. Each check reads a flag back to the host: tests and debugging
  only, never inside a timed phase.
- ``checked(fn)`` raises on a non-finite result of ``fn`` and otherwise
  returns it unchanged.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["debug_mode", "checked"]

_FACTORIES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
              "full", "full_like", "new_full", "fill", "fill_", "scalar_tensor", "lift_fresh",
              "lift_fresh_copy"}


class _NanTrap(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _FACTORIES:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, checks: bool = True):
    """Within the block, a NaN raises at the op that produced it (``nans``)
    and backwards run in anomaly mode with the NaN check (``checks``). The
    previous state is restored on exit."""
    old = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    try:
        if checks:
            torch.autograd.set_detect_anomaly(True, check_nan=True)
        with _NanTrap() if nans else contextlib.nullcontext():
            yield
    finally:
        torch.autograd.set_detect_anomaly(*old)


def checked(fn):
    """``fn`` wrapped so that a NaN or inf in its result raises
    ``FloatingPointError``; a finite result is returned unchanged."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(
                    f"non-finite value (nan or inf) in the result of {fn.__name__}")
        return out

    return wrapped
