"""The whole training step's share of the card's FP32 peak: the model
FLOPs of a step (``counts``) times the untraced steps of the window, over
their host seconds times 67e12, %."""

from gpbench.metrics import _shared


def read(rec):
    flops = rec["counts"].step_flops(rec["config"], rec["traffic"])
    return _shared.mfu_percent(flops * len(rec["untraced_units"]), rec["untraced_s"])
