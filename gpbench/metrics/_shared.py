"""Arithmetic that several readers share."""

from __future__ import annotations

from gpbench import peaks, trace


def roofline_percent(launches: list, costs: list, also: list = ()) -> float | None:
    """Σ of each launch's least time over the device time of the launches
    (and of ``also``, work they need besides), in %; None when the trace
    holds another number of launches than the counts predict (the counts no
    longer describe the path)."""
    if not launches or len(launches) != len(costs):
        return None
    bound = sum(peaks.bound_s(b, f) for b, f in costs)
    return 100.0 * bound / trace.device_time_s(launches + list(also))


def sweep_roofline(rec: dict, cot: str, other: str, costs: list) -> float | None:
    """Roofline share of the split sweep whose cotangent policy is ``cot``,
    its partial sums included; these are attributed to it only where no
    sweep of policy ``other`` ran."""
    tr = rec["trace"]
    if tr is None or tr.kernels(other):
        return None
    return roofline_percent(tr.kernels(cot), costs, tr.kernels("split_sweep_reduce"))


def mfu_percent(flops: float, seconds: float) -> float | None:
    if seconds <= 0:
        return None
    return 100.0 * flops / (seconds * peaks.PEAK_F32)
