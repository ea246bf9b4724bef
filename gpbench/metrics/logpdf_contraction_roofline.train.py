"""Roofline share of the logpdf-backward contraction (``csrc/
logpdf_contraction.cu``): the least time of its launches in the traced
steps (``counts``: bytes at 3.35e12 B/s or operations at 67e12 FLOP/s)
over their device time with their partial sums, %."""

from gpbench.metrics import _shared


def read(rec):
    per_step = rec["counts"].logpdf_contraction_launches(rec["config"], rec["traffic"])
    return _shared.sweep_roofline(rec, "LogpdfCot", "GramBwdCot",
                                  per_step * len(rec["traced_units"]))
