"""Share of the traced prediction window in which no operation ran on the
card: 1 − (union of the device operations' intervals ÷ the window), %."""

from gpbench import trace


def read(rec):
    return None if rec["trace"] is None else trace.idle_share_percent(rec["trace"])
