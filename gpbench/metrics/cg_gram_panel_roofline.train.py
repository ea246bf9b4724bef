"""Roofline share of the gram tile (``csrc/gram_tile.cu``) on the CG
matvec's panels in the traced steps: every ``gram_tile_kernel`` launch the
trace holds, each at the least time of one panel (``counts``), over their
device time, %. The launches are counted from the trace, so a step that
runs fewer matvecs reads the same share."""

from gpbench.metrics import _shared


def read(rec):
    cost = rec["counts"].gram_panel_launch(rec["config"])
    if rec["trace"] is None or cost is None:
        return None
    launches = rec["trace"].kernels("gram_tile_kernel")
    return _shared.roofline_percent(launches, [cost] * len(launches))
