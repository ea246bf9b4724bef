"""The reduction of a profiler capture to the busy union, the idle share,
the breakdown and the per-layer readers, on made-up events."""

from __future__ import annotations

import pytest

from gpbench import peaks, spec as S, trace
from gpbench.counts import exact_gp


class Ev:
    """A kineto event: name, activity type (for the test), start, duration."""

    def __init__(self, name, kind, start, dur):
        self._v = (name, kind, start, dur)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def device_type(self):
        import torch

        gpu = self._v[1].startswith(("gpu", "kernel"))
        return torch.autograd.DeviceType.CUDA if gpu else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return "annotation" in self._v[1]


def _record():
    return trace.reduce_events([Ev(*v) for v in _EVENTS])


_EVENTS = [
    (trace.WINDOW_SPAN, "user_annotation", 1000, 1000),
    (trace.WINDOW_SPAN, "gpu_user_annotation", 1000, 1000),
    ("Optimizer.step#Adam.step", "gpu_user_annotation", 1050, 900),
    ("aten::mm", "cpu_op", 1000, 300),
    ("cudaStreamSynchronize", "cuda_runtime", 1500, 400),
    ("void gram_tile_kernel<2, 8, false>(...)", "kernel", 1100, 200),
    ("void split_sweep_kernel<LogpdfCot<1>, 8>(...)", "kernel", 1250, 250),
    ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1800, 100),
    ("outside", "kernel", 2500, 100),
]


def test_busy_union_idle_share_and_breakdown():
    rec = _record()
    assert rec.window_s == pytest.approx(1e-6)
    assert trace.busy_intervals(rec) == [(1100, 1500), (1800, 1900)]
    assert trace.busy_s(rec) == pytest.approx(500e-9)
    assert trace.idle_share_percent(rec) == pytest.approx(50.0)
    assert len(rec.kernels()) == 2 and len(rec.kernels("LogpdfCot")) == 1
    b = trace.breakdown(rec)
    assert b["device_ops"][0] == ["void split_sweep_kernel<LogpdfCot<1>, 8>(...)", 250e-9]
    gaps = dict(b["idle_gaps"])
    # 1000-1100 under aten::mm, 1500-1800 in the synchronize, 1900-2000 after it
    assert gaps["aten::mm"] == pytest.approx(100e-9)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(300e-9)
    assert gaps["no traced host op (Python)"] == pytest.approx(100e-9)


def test_readers_need_the_launches_the_counts_predict():
    rec = _record()
    cfg = {"n": 8192, "d": 8, "kernel": "matern32"}
    base = {"trace": rec, "config": cfg, "traffic": {}, "counts": exact_gp,
            "untraced_units": [1, 1], "untraced_s": 0.5}
    roof = S.load_module("metrics", "logpdf_contraction_roofline.train")
    bound = peaks.bound_s(*peaks.logpdf_contraction_cost(8192, 8, 1, 2))
    assert roof.read(dict(base, traced_units=[1])) == pytest.approx(100 * bound / 250e-9)
    assert roof.read(dict(base, traced_units=[1, 1])) is None  # two predicted, one ran
    tile = S.load_module("metrics", "gram_tile_roofline.predict")
    assert tile.read(dict(base, traced_units=[16])) is None  # q = 16 is off the fused path
    b2 = peaks.bound_s(*peaks.gram_tile_cost(8192, 100, 8))
    assert tile.read(dict(base, traced_units=[100])) == pytest.approx(100 * b2 / 200e-9)
    mfu = S.load_module("metrics", "mfu.train")
    assert mfu.read(dict(base, traced_units=[1])) == pytest.approx(
        100 * 2 * exact_gp.step_flops(cfg, {}) / (0.5 * peaks.PEAK_F32))
    launches = S.load_module("metrics", "launches_per_step.train")
    assert launches.read(dict(base, traced_units=[1, 1])) == 1.0
    idle = S.load_module("metrics", "idle_share.predict")
    assert idle.read(dict(base, traced_units=[1])) == pytest.approx(50.0)
    assert idle.read(dict(base, trace=None, traced_units=[])) is None
