"""The whole query's share of the card's FP32 peak: Σ of the model FLOPs of
the untraced queries of the window (``counts``), over Σ of their latencies
times 67e12, %."""

from gpbench.metrics import _shared


def read(rec):
    flops = sum(rec["counts"].query_flops(rec["config"], q) for q in rec["untraced_units"])
    return _shared.mfu_percent(flops, rec["untraced_s"])
