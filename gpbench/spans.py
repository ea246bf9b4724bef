"""The program slice of a ``--trace 1`` run: where the card's idle time
goes, by the port's own spans.

After the window, its comparison and the existing traced slice, the first
reader that asks runs one more slice of the cell's traffic: one more
``fit`` call, or one more cycle of the query sizes (``slices/<generator>.py``
builds it from the run's seed, outside the capture). It runs with the
port's span recorder on (``abstractgps_tpu_torch.utils.profiling``) and
under a ``torch.profiler`` that records CUDA activity alone, so the
program runs at about its untraced speed. The slice counts in no
end-to-end metric, in ``attempted`` or in ``failed``, and nothing it
produces is compared.

The slice is the span ``gpbench.slice``; each call the caller makes into
the program (a ``fit`` call, a query) is a ``gpbench.call`` span inside it.
Each nanosecond of the slice in which the card ran nothing goes to a span,
and each span's name gives its layer (``layer``). Where the card waited on
the host (its next operation not launched yet), the nanosecond goes to the
innermost span open then, found by intersecting the intervals. Where its
next operation was already launched, the card waited on its own queue
(the gaps between back-to-back small kernels while the host blocks in a
copy or a sync): that time goes to the innermost span open when that
operation was launched, the layer whose work it is. An operation is
matched to its launch call by the profiler's correlation id.

Clocks: the recorder's spans and the profiler's host events (the CUDA
runtime calls) share ``time.time_ns()``. The card's operations are stamped
from the card's timer, which has read up to ~5 ms off it on an H100 and
drifted by up to ~1 ms over a 3 s capture: ``align_device`` puts them back
on the host's clock before anything is intersected.

A program without the recorder (older than it), or a traffic mix with no
slice driver, has no slice: the readers then find nothing to read.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import heapq
import sys

from gpbench import spec as S
from gpbench import trace

SLICE_SPAN = "gpbench.slice"
CALL_SPAN = "gpbench.call"
LAYERS = ("loop", "model", "ops", "harness", "none")
_LAUNCH_NS = 3_000       # a launch call's start to its operation's start on an idle H100
_WAITED_NS = 20_000      # an operation after this much idle is one the card waited for
_BIN_NS = 20_000_000     # the time bins of the card's offset
_TOP = 8  # spans named in the [spans] line


def layer(name: str | None) -> str:
    """The layer of a span (PERF.md §3): ``ops.*`` the autograd rules and
    sweep drivers; ``fit.loss``, ``fit.backward``, ``model.*`` and
    ``posterior.*`` the models (the loss and its backward are the model's
    time, seen from the loop); the other ``fit.*`` the training loop;
    ``gpbench.*`` the harness; no span, ``none``."""
    if name is None:
        return "none"
    if name.startswith("ops."):
        return "ops"
    if name in ("fit.loss", "fit.backward") or name.startswith(("model.", "posterior.")):
        return "model"
    if name.startswith("fit."):
        return "loop"
    if name.startswith("gpbench."):
        return "harness"
    return "none"


def idle_intervals(window: tuple, busy: list) -> list:
    """The window minus ``busy`` (sorted disjoint intervals), as sorted
    disjoint (start, end)."""
    out, prev = [], window[0]
    for s, e in busy:
        if s > prev:
            out.append((prev, min(s, window[1])))
        prev = max(prev, e)
        if prev >= window[1]:
            break
    if prev < window[1]:
        out.append((prev, window[1]))
    return [iv for iv in out if iv[1] > iv[0]]


def innermost_segments(window: tuple, spans: list) -> list:
    """The window cut at every span edge into (start, end, index) pieces,
    ``index`` the innermost span open through the piece (the one that
    opened last; None where none is)."""
    w0, w1 = window
    edges = sorted({w0, w1, *(t for sp in spans for t in (sp.start_ns, sp.end_ns)
                              if w0 < t < w1)})
    order = sorted(range(len(spans)), key=lambda i: (spans[i].start_ns, i))
    heap, k, out = [], 0, []
    for a, b in zip(edges, edges[1:]):
        while k < len(order) and spans[order[k]].start_ns <= a:
            i = order[k]
            heapq.heappush(heap, (-spans[i].start_ns, -i))
            k += 1
        while heap and spans[-heap[0][1]].end_ns <= a:
            heapq.heappop(heap)
        out.append((a, b, -heap[0][1] if heap else None))
    return out


def align_device(device: list) -> tuple:
    """(``device`` moved onto the host's clock, (least, most) shift in ns and
    the number of operations that set it).
    ``device`` holds (name, kind, start, end, launch). An operation that
    starts after the card sat idle ``_WAITED_NS`` or more (a gap on the
    card's own timer) is one the card waited for: it started about
    ``_LAUNCH_NS`` after the call that launched it began, so its start −
    launch start, less that, is the card's offset then. Each ``_BIN_NS`` of
    host time takes the third least of its samples (a mismatched pair or
    two cannot move it); the offset runs linearly between the bins'
    centres (the timer drifts, and has jumped by milliseconds within a
    capture). An operation takes the offset at its launch call, or, with
    none, at its own start."""
    samples: dict = {}
    busy_end = None
    for _, _, s, e, ln in sorted(device, key=lambda d: d[2]):
        if ln is not None and busy_end is not None and s - busy_end >= _WAITED_NS:
            samples.setdefault(ln[0] // _BIN_NS, []).append(s - ln[0])
        busy_end = e if busy_end is None else max(busy_end, e)
    if not samples:
        return device, (0, 0, 0)
    ks = sorted(samples)
    xs = [(k + 0.5) * _BIN_NS for k in ks]
    ys = [sorted(samples[k])[min(2, len(samples[k]) - 1)] - _LAUNCH_NS for k in ks]

    def offset(t):
        i = bisect.bisect_left(xs, t)
        if i == 0 or i == len(xs):
            return ys[min(i, len(xs) - 1)]
        w = (t - xs[i - 1]) / (xs[i] - xs[i - 1])
        return round(ys[i - 1] + w * (ys[i] - ys[i - 1]))

    out = []
    for name, kind, s, e, ln in device:
        off = offset(ln[0] if ln is not None else s)
        out.append((name, kind, s - off, e - off, ln))
    return out, (min(ys), max(ys), sum(len(v) for v in samples.values()))


def idle_pieces(window: tuple, device: list) -> list:
    """The window's idle time as sorted (start, end, at) pieces. ``device``
    holds (name, kind, start, end, launch) of the card's operations,
    ``launch`` the (start, end) of the host call that launched it, or None.
    A gap that the card spent with its next operation already launched is
    queued from the launch call's end on: that piece has ``at`` = the
    launch call's start. The rest has ``at`` None."""
    rec = trace.TraceRecord(window, [e[:4] for e in device], [])
    launched: dict = {}  # start of an operation → the earliest-ending launch of one there
    for e in device:
        if e[4] is not None and (e[2] not in launched or e[4][1] < launched[e[2]][1]):
            launched[e[2]] = e[4]
    out = []
    for a, b in idle_intervals(window, trace.busy_intervals(rec)):
        ln = launched.get(b)
        t = b if ln is None else min(max(ln[1], a), b)
        if t > a:
            out.append((a, t, None))
        if b > t:
            out.append((t, b, ln[0]))
    return out


def idle_by_span(window: tuple, pieces: list, spans: list) -> tuple:
    """(idle ns of each span, idle ns under no span): each piece of
    ``idle_pieces`` with ``at`` None goes nanosecond by nanosecond to the
    innermost span open (``innermost_segments``), one with ``at`` whole to
    the innermost span open at ``at``."""
    per = [0] * len(spans)
    outside = 0
    segs = innermost_segments(window, spans)
    starts = [a for a, _, _ in segs]
    for a, b, at in pieces:
        if at is not None:
            k = bisect.bisect_right(starts, at) - 1
            i = segs[k][2] if k >= 0 and at < window[1] else None
            if i is None:
                outside += b - a
            else:
                per[i] += b - a
            continue
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(segs) and segs[k][0] < b:
            sa, sb, i = segs[k]
            ns = min(b, sb) - max(a, sa)
            if ns > 0:
                if i is None:
                    outside += ns
                else:
                    per[i] += ns
            k += 1
    return per, outside


@dataclasses.dataclass
class ProgramSlice:
    """What the reduction keeps of one program slice."""

    root: str            # the unit root of the slice's units
    units: int           # units (steps, queries) in the slice
    seconds: float       # the slice span's length
    idle_ns: dict        # layer → device idle ns under its spans
    idle_by_name: dict   # span name → device idle ns given to it
    queued_ns: int       # of the idle ns, those the card spent on its own queue
    counts: dict         # counter → Σ over the unit roots
    spans: int           # spans recorded in the slice
    most_spans: int      # spans of the unit with most
    launches: tuple      # (cudaLaunchKernel* calls inside a unit root, all of them)
    kernels: tuple       # (kernels the card ran, kernel launch calls of the host)
    linked: tuple        # (operations matched to a launch call, all, those before it)
    shift_ns: tuple = (0, 0, 0)  # (least, most) shift of the card's stamps, its samples

    def idle_ms_per_unit(self, layer_name: str) -> float | None:
        return self.idle_ns[layer_name] / self.units / 1e6 if self.units else None


def reduce_slice(window: tuple, device: list, launches: list, spans: list) -> ProgramSlice:
    """The slice's reduction: ``device`` as (name, kind, start, end, launch)
    of the card's operations (``idle_pieces``), ``launches`` as (name,
    start, end) of the host's kernel launch calls (runtime and driver),
    ``spans`` the recorder's spans, all on one clock."""
    pieces = idle_pieces(window, device)
    per, outside = idle_by_span(window, pieces, spans)
    idle_ns = dict.fromkeys(LAYERS, 0)
    idle_ns["none"] = outside
    by_name: dict = {}
    for sp, ns in zip(spans, per):
        idle_ns[layer(sp.name)] += ns
        by_name[sp.name] = by_name.get(sp.name, 0) + ns
    roots = [sp for sp in spans if sp.unit >= 0 and (sp.parent < 0 or spans[sp.parent].unit < 0)]
    counts: dict = {}
    for sp in roots:
        for k, v in sp.counts.items():
            counts[k] = counts.get(k, 0) + v
    per_unit: dict = {}
    for sp in spans:
        if sp.unit >= 0:
            per_unit[sp.unit] = per_unit.get(sp.unit, 0) + 1
    names = sorted({sp.name for sp in roots})
    iv = sorted((sp.start_ns, sp.end_ns) for sp in roots)
    runtime = [(s, e) for n, s, e in launches if n.startswith("cudaLaunchKernel")]
    inside = sum(1 for s, e in runtime if _within(iv, s, e))
    return ProgramSlice(root=",".join(names), units=len(roots),
                        seconds=(window[1] - window[0]) / 1e9, idle_ns=idle_ns,
                        idle_by_name=by_name,
                        queued_ns=sum(b - a for a, b, at in pieces if at is not None),
                        counts=counts, spans=len(spans),
                        most_spans=max(per_unit.values(), default=0),
                        launches=(inside, len(runtime)),
                        kernels=(sum(1 for e in device if e[1] == "kernel"), len(launches)),
                        linked=(sum(1 for e in device if e[4] is not None), len(device),
                                sum(1 for e in device if e[4] is not None and e[2] < e[4][0])))


def _within(intervals: list, s: int, e: int) -> bool:
    """Whether [s, e] lies inside one of the sorted disjoint ``intervals``."""
    k = bisect.bisect_right(intervals, (s, float("inf"))) - 1
    return k >= 0 and intervals[k][0] <= s and e <= intervals[k][1]


def _recorder():
    """The port's span recorder, or None where the port has none."""
    from abstractgps_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "recording") else None


def run_seed() -> int:
    """The run's ``--seed`` from the command line (0 where there is none:
    a run driven from a test's own process)."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def capture(run) -> ProgramSlice:
    """Run ``run(span)`` as a program slice and reduce it; ``span`` is the
    recorder's, for the harness's ``gpbench.call`` spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    profiling = _recorder()
    on_card = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CUDA]) if on_card else contextlib.nullcontext()
    with profiling.recording() as rec, prof:
        with profiling.span(SLICE_SPAN):
            run(profiling.span)
            if on_card:
                torch.cuda.synchronize()
    sp = [s for s in rec.spans if s.name == SLICE_SPAN][-1]
    window = (sp.start_ns, sp.end_ns)
    raw = list(prof.profiler.kineto_results.events()) if on_card else []
    events = list(zip(trace._kinds(raw), (e.correlation_id() for e in raw)))
    calls: dict = {}  # correlation id → (start, end) of the one host call that has it
    for (_, kind, s, e), corr in events:
        if kind == "cuda_runtime" and corr > 0:
            calls[corr] = None if corr in calls else (s, e)
    device, shift = align_device([(name, kind, s, e, calls.get(corr) if corr > 0 else None)
                                  for (name, kind, s, e), corr in events
                                  if kind in trace._DEVICE_KINDS])
    device = sorted((d for d in device if d[3] > window[0] and d[2] < window[1]),
                    key=lambda d: d[2])
    launches = [(n, s, e) for (n, kind, s, e), _ in events if kind == "cuda_runtime"
                and "LaunchKernel" in n and window[0] <= s < window[1]]
    return dataclasses.replace(reduce_slice(window, device, launches, rec.spans),
                               shift_ns=shift)


_SLICES: dict = {}  # id of a run's TraceRecord → (the record, its ProgramSlice or None)


def program_slice(rec: dict) -> ProgramSlice | None:
    """The run's program slice, made once, for the first reader that asks;
    None where the port has no recorder or the traffic no slice driver."""
    key = id(rec["trace"])
    if key not in _SLICES:
        _SLICES[key] = (rec["trace"], _make(rec))
    return _SLICES[key][1]


def _make(rec: dict) -> ProgramSlice | None:
    if _recorder() is None:
        return None
    try:
        driver = S.load_module("slices", rec["traffic"]["generator"])
    except S.SpecError:
        return None
    import torch

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    sl = capture(driver.prepare(rec, run_seed(), device))
    print(spans_line(sl, rec), file=sys.stderr, flush=True)
    return sl


def spans_line(sl: ProgramSlice, rec: dict) -> str:
    """The ``[spans]`` line: the slice against the untraced window, the idle
    time by layer and by span a unit, the launch calls inside units, and
    the counters a unit."""
    u = max(sl.units, 1)
    ms = sl.seconds * 1e3 / u
    untraced = (rec["untraced_s"] * 1e3 / len(rec["untraced_units"])
                if rec.get("untraced_units") else float("nan"))
    idle = sum(sl.idle_ns.values()) or 1
    share = {k: 100.0 * v / idle for k, v in sl.idle_ns.items()}
    top = sorted(sl.idle_by_name.items(), key=lambda kv: -kv[1])[:_TOP]
    inside, launches = sl.launches
    return ("[spans] slice: " + f"{sl.units} units ({sl.root}) in {sl.seconds:.6f} s, "
            f"{ms:.6f} ms a unit (untraced window {untraced:.6f} ms, ratio "
            f"{ms / untraced:.4f}); {sl.spans} spans, at most {sl.most_spans} a unit; "
            f"device idle {idle / u / 1e6:.6f} ms a unit, by layer "
            + ", ".join(f"{k} {v / u / 1e6:.6f} ms ({share[k]:.2f} %)"
                        for k, v in sl.idle_ns.items())
            + f"; queued on the card {sl.queued_ns / u / 1e6:.6f} ms a unit of it"
            + "; by span " + ", ".join(f"{k} {v / u / 1e6:.6f}" for k, v in top)
            + f"; cudaLaunchKernel calls inside a unit {inside} of {launches}"
            + (f" ({100.0 * inside / launches:.3f} %)" if launches else "")
            + f"; {sl.kernels[0]} kernels recorded of {sl.kernels[1]} launch calls"
            + f"; operations matched to their launch {sl.linked[0]} of {sl.linked[1]}, "
            f"{sl.linked[2]} of them before it; card stamps moved {-sl.shift_ns[1] / 1e3:.3f} "
            f"to {-sl.shift_ns[0] / 1e3:.3f} us by {sl.shift_ns[2]} operations it waited for"
            + "; counts a unit " + ", ".join(f"{k} {v / u:.3f}"
                                              for k, v in sorted(sl.counts.items())))


def idle_ms_per_unit(rec: dict, layer_name: str, root: str) -> float | None:
    """A reader's value: the slice's device idle ms a unit under ``layer``'s
    spans, where the slice's units are ``root`` spans."""
    sl = program_slice(rec)
    if sl is None or sl.root != root:
        return None
    return sl.idle_ms_per_unit(layer_name)
