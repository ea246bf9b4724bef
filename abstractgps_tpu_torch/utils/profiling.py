"""Tracing and roofline accounting.

Counterpart of the JAX package's ``utils/profiling.py``, with the port's
own spans:

- ``span(name)`` marks a layer boundary of the program. Off (the default)
  it is one flag test returning a shared object that does nothing. Inside
  ``with recording() as rec:`` each span appends a ``Span`` to
  ``rec.spans``: its name, start and end on ``time.time_ns()`` (the clock
  of ``torch.profiler``'s events), its parent, its unit, and the launch,
  collective and library-call counters at its entry and exit.
- ``trace(logdir)`` records the spans of a block beside a
  ``torch.profiler`` capture and writes both to one Chrome trace.
- ``LIBRARY_CALLS`` counts the library calls of the ops layer at their
  wrappers, as ``ops.cuda.LAUNCHES`` counts the hand-written kernels, the
  CG solver's matvecs, and the Markov scan's cross-chunk combines.
- ``timed`` measures a block's wall time with a device sync at its end;
  ``roofline`` turns a measured time into achieved FLOP/s and a fraction
  of the card's peak.

The stack of open spans is the process's, not a thread's: autograd runs
the backward of CUDA tensors on a thread of its own while the caller
blocks in ``backward()``, and the backward's spans belong under the
caller's. A span named in ``UNIT_ROOTS`` that opens outside any unit
starts a new unit (a training step, a query); every span inside it
carries that unit's id.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass

import torch

__all__ = ["span", "recording", "is_recording", "Recording", "Span", "UNIT_ROOTS",
           "LIBRARY_CALLS", "reset_library_calls", "trace", "timed", "roofline", "Roofline",
           "cholesky_flops", "H100_PEAK_F32"]

# the FP32 (non-tensor-core) peak of one H100 SXM from NVIDIA's datasheet,
# 67 TFLOP/s: a published figure, not a measurement
H100_PEAK_F32 = 67e12

# library calls of the ops layer, counted by the wrapper that makes them:
# ``blocked_chol._mm`` GEMMs, ``covmat._tri_solve`` TRSMs,
# ``covmat.cholesky_lower`` factors, the trtris of the wide solves and of
# ``covmat.Whitener``, the Whitener's products with its held inverse; the matvecs of
# ``iterative.mbcg``, the steps under its ``max_iters`` that it skipped once
# every column had frozen, and the steps it ran with no column active, the
# exit's lag (counted only while a ``recording()`` is open: it takes a host
# read of the solver's state); the matvecs that took ``ops.matvec``'s fused
# route (one launch of ``gram_matvec``); the cross-chunk combines of the
# Markov backend's chunked scan, made one after another on the host
LIBRARY_CALLS = {"mm": 0, "tri_solve": 0, "cholesky_lower": 0, "wide_inverse": 0,
                 "whiten_cached": 0, "cg_matvec": 0, "cg_skipped_matvec": 0,
                 "cg_converged_matvec": 0, "cg_fused_matvec": 0, "markov_carry_combine": 0}

UNIT_ROOTS = ("fit.step", "posterior.mean_and_var")


def reset_library_calls() -> None:
    for name in LIBRARY_CALLS:
        LIBRARY_CALLS[name] = 0


class Span:
    """One recorded span. ``parent`` and ``unit`` are -1 where there is
    none; ``counts`` is what the counters added while it was open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "unit", "_names", "_at_entry",
                 "_at_exit")

    def __init__(self, name, start_ns, parent, unit, names, at_entry):
        self.name, self.start_ns, self.end_ns = name, start_ns, start_ns
        self.parent, self.unit = parent, unit
        self._names, self._at_entry, self._at_exit = names, at_entry, at_entry

    @property
    def counts(self) -> dict:
        return {k: b - a for k, a, b in zip(self._names, self._at_entry, self._at_exit)
                if b != a}


class Recording:
    """The spans of one ``recording()`` block, in the order they opened;
    ``counter_names`` names the counters a span's ``counts`` holds."""

    def __init__(self, counter_names: tuple):
        self.counter_names = counter_names
        self.spans: list[Span] = []
        self.units = 0


_ON = False
_REC: Recording | None = None
_STACK: list[int] = []  # indices of the open spans in _REC.spans
_COUNTERS: tuple = ()   # the counter dicts a span snapshots


def _snapshot() -> tuple:
    a, b, c = _COUNTERS
    return (*a.values(), *b.values(), *c.values())


_OFF = contextlib.nullcontext()  # what ``span`` returns while nothing records


class _On:
    __slots__ = ("name", "rec", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = self.rec = _REC
        parent = _STACK[-1] if _STACK else -1
        unit = rec.spans[parent].unit if parent >= 0 else -1
        if unit < 0 and self.name in UNIT_ROOTS:
            unit, rec.units = rec.units, rec.units + 1
        self.index = len(rec.spans)
        rec.spans.append(Span(self.name, time.time_ns(), parent, unit, rec.counter_names,
                              _snapshot()))
        _STACK.append(self.index)
        return None

    def __exit__(self, *exc):
        sp = self.rec.spans[self.index]
        sp.end_ns = time.time_ns()
        sp._at_exit = _snapshot()
        if _STACK and _STACK[-1] == self.index:
            _STACK.pop()
        elif self.index in _STACK:
            _STACK.remove(self.index)
        return False


def span(name: str):
    """``with span("ops.sweep"): ...`` records the block while a
    ``recording()`` is open, and does nothing otherwise."""
    if not _ON:
        return _OFF
    return _On(name)


def is_recording() -> bool:
    """Whether a ``recording()`` block is open."""
    return _ON


@contextlib.contextmanager
def recording():
    """``with recording() as rec:`` turns the spans on for the block;
    ``rec.spans`` holds them after it. Not reentrant."""
    global _ON, _REC, _COUNTERS
    if _ON:
        raise RuntimeError("profiling.recording() is already open")
    from ..ops import cuda
    from ..parallel import collectives

    _COUNTERS = (cuda.LAUNCHES, collectives.COLLECTIVES, LIBRARY_CALLS)
    names = tuple(f"{kind}.{k}" for kind, d in zip(("launch", "collective", "library"),
                                                      _COUNTERS) for k in d)
    rec = Recording(names)
    _STACK.clear()
    _REC, _ON = rec, True
    try:
        yield rec
    finally:
        _ON, _REC = False, None
        _STACK.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace("prof"): ...`` → ``prof/trace.json``, a Chrome trace of
    the block: CPU ops, the card's kernels when CUDA is available, and the
    program's spans (category ``program_span``, one row of their own) on
    the same clock."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with recording() as rec, torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, rec)


def _add_spans(path: str, rec: Recording) -> None:
    """Append ``rec``'s spans to the Chrome trace at ``path`` as complete
    events, in µs from the trace's ``baseTimeNanoseconds``."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), 1  # a row of their own (real thread ids are larger)
    doc["traceEvents"].append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                               "args": {"name": "program spans"}})
    for i, sp in enumerate(rec.spans):
        args = {"index": i, "parent": sp.parent, "unit": sp.unit, **sp.counts}
        doc["traceEvents"].append({"ph": "X", "cat": "program_span", "name": sp.name,
                                   "pid": pid, "tid": tid,
                                   "ts": (sp.start_ns - base) / 1e3,
                                   "dur": (sp.end_ns - sp.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def timed(out: dict, key: str = "seconds"):
    """Measure a block's wall time into ``out[key]``, synchronising the
    current CUDA device at the end (nothing more on the CPU)."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    out[key] = time.perf_counter() - t0


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
