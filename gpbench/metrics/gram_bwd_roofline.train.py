"""Roofline share of the gram VJP (``csrc/gram_bwd.cu``, all three modes):
the least time of its launches in the traced steps (``counts``) over their
device time with their partial sums, %."""

from gpbench.metrics import _shared


def read(rec):
    per_step = rec["counts"].gram_bwd_launches(rec["config"], rec["traffic"])
    return _shared.sweep_roofline(rec, "GramBwdCot", "LogpdfCot",
                                  per_step * len(rec["traced_units"]))
