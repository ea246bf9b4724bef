"""The traced slice of a ``--trace 1`` run: a ``torch.profiler`` capture
reduced to plain intervals, the device's busy union, and the breakdown.

The benchmark records one span of its own, ``gpbench.window``, around the
traced units; every interval below is clipped to it. Device operations
are the card's kernels, copies and fills; host operations are the
profiler's CPU ops, the CUDA runtime calls and the benchmark's spans.
"""

from __future__ import annotations

import contextlib
import dataclasses

WINDOW_SPAN = "gpbench.window"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class TraceRecord:
    """Intervals in ns on the profiler's clock: ``device`` as (name, kind,
    start, end), ``host`` as (name, start, end), ``window`` as (start, end)."""

    window: tuple[int, int]
    device: list
    host: list

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self, needle: str | None = None) -> list:
        """Kernel intervals (copies and fills left out), those whose name
        holds ``needle`` when it is given."""
        return [e for e in self.device
                if e[1] == "kernel" and (needle is None or needle in e[0])]


@contextlib.contextmanager
def traced():
    """``with traced() as box:`` profiles the block inside one
    ``gpbench.window`` span and leaves its ``TraceRecord`` in ``box[0]``.
    The block ends with a synchronize, so its work is in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    box = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield box
            torch.cuda.synchronize()
    box.append(reduce_events(prof.profiler.kineto_results.events()))


def _kinds(events) -> list:
    """(name, kind, start, end) of each kineto event, classified from its
    device type, its user-annotation flag and its name (builds differ in
    what else an event carries): on the card a copy, a fill, the GPU-side
    copy of a host annotation or a kernel; on the host an annotation, a
    CUDA runtime or driver call, or an operator."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in events:
        n, s = e.name(), e.start_ns()
        if e.device_type() == cuda:
            kind = ("gpu_memcpy" if n.startswith("Memcpy") else
                    "gpu_memset" if n.startswith("Memset") else
                    "gpu_user_annotation" if e.is_user_annotation() else "kernel")
        else:
            kind = ("user_annotation" if e.is_user_annotation() else
                    "cuda_runtime" if n.startswith(("cuda", "cu")) else "cpu_op")
        out.append((n, kind, s, s + e.duration_ns()))
    return out


def reduce_events(events) -> TraceRecord:
    """The window span and the device and host intervals inside it."""
    window = None
    device, host = [], []
    for name, kind, s, e in _kinds(events):
        if kind == "user_annotation" and name == WINDOW_SPAN:
            window = (s, e)
        elif kind in _DEVICE_KINDS:
            device.append((name, kind, s, e))
        elif kind in _HOST_KINDS:
            host.append((name, s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1 = window
    device = sorted((e for e in device if e[3] > w0 and e[2] < w1), key=lambda e: e[2])
    host = sorted((e for e in host if e[2] > w0 and e[1] < w1 and e[0] != WINDOW_SPAN),
                  key=lambda e: (e[1], -e[2]))
    return TraceRecord(window, device, host)


def busy_intervals(rec: TraceRecord) -> list:
    """The union of the device operations' intervals, clipped to the window,
    as sorted disjoint (start, end)."""
    w0, w1 = rec.window
    out = []
    for _, _, s, e in rec.device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def busy_s(rec: TraceRecord) -> float:
    return sum(e - s for s, e in busy_intervals(rec)) / 1e9


def idle_share_percent(rec: TraceRecord) -> float:
    return 100.0 * (1.0 - busy_s(rec) / rec.window_s)


def device_time_s(intervals) -> float:
    return sum(e[3] - e[2] for e in intervals) / 1e9


def _innermost_hosts(rec: TraceRecord, times: list) -> list:
    """For each time of the ascending ``times``, the name of the innermost
    host operation running then: the one that started last among those that
    cover it. One sweep: host operations are pushed in start order, and
    those that ended before the time are popped off the top."""
    names, stack, i = [], [], 0
    for t in times:
        while i < len(rec.host) and rec.host[i][1] <= t:
            stack.append(rec.host[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        names.append(stack[-1][0] if stack else "no traced host op (Python)")
    return names


def breakdown(rec: TraceRecord, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle time
    of the device by the host operation running in the middle of each gap,
    each with its seconds, at most ``top`` entries each."""
    by_name: dict = {}
    for name, _, s, e in rec.device:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans, prev = [], rec.window[0]
    for s, e in busy_intervals(rec) + [(rec.window[1], rec.window[1])]:
        if s > prev:
            spans.append((prev, s))
        prev = max(prev, e)
    gaps: dict = {}
    for (s, e), name in zip(spans, _innermost_hosts(rec, [(s + e) // 2 for s, e in spans])):
        gaps[name] = gaps.get(name, 0) + (e - s)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], t / 1e9] for n, t in ops],
            "idle_gaps": [[n[:200], t / 1e9] for n, t in idle]}
