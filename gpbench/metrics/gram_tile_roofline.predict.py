"""Roofline share of the fused gram tile (``csrc/gram_tile.cu``) in the
traced queries: the least time of the launches that each query's size
needs (``counts``) over the device time of ``gram_tile_kernel``, %."""

from gpbench.metrics import _shared


def read(rec):
    if rec["trace"] is None:
        return None
    costs = [c for q in rec["traced_units"]
             for c in rec["counts"].gram_tile_launches(rec["config"], q)]
    return _shared.roofline_percent(rec["trace"].kernels("gram_tile_kernel"), costs)
