"""The program slice (``gpbench.spans``): the idle time by innermost span on
made-up timelines, the six readers on small CPU runs, a traced run that
reports what it reported without the slice, and a port without the
recorder, whose readers find nothing to read."""

from __future__ import annotations

import json
from types import SimpleNamespace as Sp

import pytest

from gpbench import spans
from gpbench.tests.conftest import CPU_RUN, run_python

NEW = {"exact8k.train": ("loop_idle_ms.train", "model_idle_ms.train", "ops_idle_ms.train"),
       "svgp50k.train": ("loop_idle_ms.train", "model_idle_ms.train", "ops_idle_ms.train"),
       "exact8k.predict": ("model_idle_ms.predict", "ops_idle_ms.predict",
                           "wide_inverse_per_query.predict")}


def _span(name, start, end, parent=-1, unit=-1, counts=None):
    return Sp(name=name, start_ns=start, end_ns=end, parent=parent, unit=unit,
              counts=counts or {})


def test_idle_goes_to_the_innermost_span_open():
    # slice 0-100; a unit 10-90 holding the loss 20-50 and, inside it, an op
    # 30-40; the card busy 25-35 and 45-60
    sl = [_span("gpbench.slice", 0, 100), _span("fit.step", 10, 90, 0, 0),
          _span("fit.loss", 20, 50, 1, 0), _span("ops.sweep", 30, 40, 2, 0)]
    device = [("k", "kernel", 25, 35, None), ("k", "kernel", 45, 60, None)]
    per, outside = spans.idle_by_span((0, 100), spans.idle_pieces((0, 100), device), sl)
    # slice: 0-10 and 90-100; step: 10-20, 60-90; loss: 20-25, 40-45; op: 35-40
    assert per == [20, 40, 10, 5] and outside == 0
    assert sum(per) + outside == 100 - 25


def test_a_gap_across_a_span_edge_and_time_outside_every_span():
    # the idle gap 30-70 crosses the op's end at 50 and the step's end at 60;
    # nothing is open over 60-100
    sl = [_span("fit.step", 0, 60, unit=0), _span("ops.trsm", 20, 50, 0, 0)]
    device = [("k", "kernel", 0, 30, None), ("k", "kernel", 70, 80, None)]
    per, outside = spans.idle_by_span((0, 100), spans.idle_pieces((0, 100), device), sl)
    assert per == [10, 20] and outside == 30
    # two siblings; the later one is innermost only while it is open
    sl = [_span("a", 0, 100), _span("b", 10, 20, 0), _span("c", 20, 30, 0)]
    per, outside = spans.idle_by_span((0, 100), spans.idle_pieces((0, 100), []), sl)
    assert per == [80, 10, 10] and outside == 0


def test_time_the_card_spends_on_its_own_queue_goes_to_the_launching_span():
    # a query 0-50 whose inverse (10-40) launches A (at 12) and B (at 20);
    # the caller then blocks in a copy (50-100) while the card runs A, B,
    # and C, launched from the copy at 75
    sl = [_span("gpbench.call", 0, 100), _span("posterior.mean_and_var", 0, 50, 0, 0),
          _span("ops.wide_solve.inverse", 10, 40, 1, 0)]
    device = [("A", "kernel", 45, 60, (12, 14)), ("B", "kernel", 62, 70, (20, 22)),
              ("C", "gpu_memcpy", 80, 90, (75, 78))]
    pieces = spans.idle_pieces((0, 100), device)
    assert pieces == [(0, 14, None), (14, 45, 12), (60, 62, 20), (70, 78, None),
                      (78, 80, 75), (90, 100, None)]
    per, outside = spans.idle_by_span((0, 100), pieces, sl)
    # the query 0-10; the inverse 10-14, then A's and B's queue 14-45, 60-62;
    # the copy: waiting on the host 70-78, C's launch latency 78-80, 90-100
    assert per == [8 + 2 + 10, 10, 4 + 31 + 2] and outside == 0
    got = spans.reduce_slice((0, 100), device, [], sl)
    assert got.queued_ns == 31 + 2 + 2 and got.linked == (3, 3, 0)
    assert got.idle_ns["ops"] == 37 and got.idle_ns["harness"] == 20


def test_align_device_puts_the_cards_stamps_on_the_hosts_clock():
    # 400 ms on a timer that runs 300 ppm fast of the host's and jumps 3 ms
    # back at 300 ms. Each millisecond the host launches one operation onto
    # the idle card (it starts 3 us after its launch call began), except
    # over 120-180 ms, where it launches bursts of eight every 400 us that
    # run back to back; and one copy has no launch
    def stamp(ls, true):
        return true + int(300e-6 * (ls - 10**9)) + 7_000 - (3_000_000 if ls >= 10**9 + 3 * 10**8
                                                             else 0)

    device, truth = [], []
    for i in range(400):
        ls = 10**9 + i * 10**6
        if 120 <= i < 180:
            for b in range(2):
                t = ls + b * 400_000 + 3_000
                for j in range(8):  # launched 2 us apart, each runs 20 us
                    lj = ls + b * 400_000 + j * 2_000
                    truth.append((t, lj))
                    device.append(("k", "kernel", stamp(lj, t), stamp(lj, t) + 20_000,
                                   (lj, lj + 1_500)))
                    t += 21_000
            continue
        truth.append((ls + 3_000, ls))
        device.append(("k", "kernel", stamp(ls, ls + 3_000), stamp(ls, ls + 3_000) + 20_000,
                       (ls, ls + 1_500)))
    device.append(("m", "gpu_memcpy", device[-1][2] + 50_000, device[-1][2] + 60_000, None))
    got, shift = spans.align_device(device)
    for (_, _, s, e, ln), (true, ls) in zip(got, truth):
        if 2.8e8 <= ls - 10**9 < 3.2e8:  # the jump is resolved to a bin either side
            continue
        assert abs(s - true) <= 6_000 and e - s == 20_000, (ls, s - true)
    assert abs(got[-1][2] - (got[-2][2] + 50_000)) <= 6_000
    assert -2_910_000 <= shift[0] <= -2_895_000 and 85_000 <= shift[1] <= 95_000
    # every lone operation but the first and each burst's first, less those
    # the jump sorts behind earlier ones
    assert 339 + 120 - 3 <= shift[2] <= 339 + 120
    assert spans.align_device([("k", "kernel", 5, 9, None)]) == ([("k", "kernel", 5, 9, None)],
                                                                  (0, 0, 0))


def test_reduce_slice_sums_layers_units_counts_and_launches():
    sl = [_span("gpbench.slice", 0, 200), _span("gpbench.call", 5, 195, 0),
          _span("fit.step", 10, 100, 1, 0, {"library.mm": 3}),
          _span("fit.optimizer", 80, 100, 2, 0),
          _span("fit.step", 100, 190, 1, 1, {"library.mm": 2, "launch.gram_tile": 1}),
          _span("fit.loss", 100, 150, 4, 1), _span("ops.sweep", 110, 140, 5, 1)]
    device = [("k", "kernel", 20, 80, None), ("k", "kernel", 120, 130, None),
              ("m", "gpu_memcpy", 150, 185, None)]
    launches = [("cudaLaunchKernel", 15, 16), ("cuLaunchKernelEx", 20, 21),
                ("cudaLaunchKernelExC", 115, 116), ("cudaLaunchKernel", 196, 197)]
    got = spans.reduce_slice((0, 200), device, launches, sl)
    assert got.units == 2 and got.root == "fit.step" and got.spans == 7
    assert got.idle_ns == {"loop": 10 + 20 + 5, "model": 10 + 10, "ops": 10 + 10,
                           "harness": 5 + 5 + 5 + 5, "none": 0}
    assert got.counts == {"library.mm": 5, "launch.gram_tile": 1}
    assert got.launches == (2, 3) and got.kernels == (2, 4) and got.most_spans == 3
    assert got.idle_ms_per_unit("ops") == 10e-6
    assert spans.layer("posterior.mean_and_var") == "model" and spans.layer(None) == "none"


TRACED = CPU_RUN + """
torch.cuda.synchronize = lambda *a, **k: None  # the traced slice ends in one
def traced(cell, seconds):
    import contextlib, io
    buf, err = io.StringIO(), io.StringIO()
    rc = R.execute(["--workload", cell, "--seed", "2147483661", "--seconds", str(seconds),
                    "--trace", "1"], device=torch.device("cpu"), out=buf, err=err)
    assert rc == 0, (rc, err.getvalue()[-2000:])
    return json.loads(buf.getvalue().strip().splitlines()[-1])
"""


@pytest.mark.parametrize("cell", sorted(NEW))
def test_readers_on_a_small_cpu_run_and_the_rest_of_the_line_unchanged(small_root, cell):
    # a window of one call, so that both runs compare the same answers; the
    # wide solve on at these sizes, through the plain versions
    code = TRACED + f"""
from abstractgps_tpu_torch.ops import blocked_chol, fused_gram
blocked_chol.set_interpret(True); fused_gram.set_interpret(True)
blocked_chol._MIN_N, blocked_chol._BLOCK, blocked_chol._OUTER = 256, 32, 128
fused_gram._MIN_SIZE = 64 * 64
with_slice = traced({cell!r}, 1e-4)
import pathlib
bench = pathlib.Path("BENCHMARK.json")
full = bench.read_text()
b = json.loads(full)
b["per_layer"] = [m for m in b["per_layer"] if m["name"] not in {list(NEW[cell])!r}]
bench.write_text(json.dumps(b))
without = traced({cell!r}, 1e-4)
bench.write_text(full)
from gpbench.generators import predict
traffic = S.load_cell({cell!r}).traffic
sizes = predict.query_sizes(traffic["sizes"]) if "sizes" in traffic else [0]
print(json.dumps({{"with": with_slice, "without": without,
                   "wide": sum(q >= 256 for q in sizes) / len(sizes)}}))
"""
    res = run_python(small_root, code)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    a, b = got["with"], got["without"]
    assert "[spans] slice:" in res.stderr
    for name in NEW[cell]:
        assert name in a["metrics"] and name not in b["metrics"]
        assert a["metrics"][name]["value"] >= 0.0
    if cell == "exact8k.predict":
        assert a["metrics"]["wide_inverse_per_query.predict"]["value"] == got["wide"] > 0
    else:  # on the CPU the whole slice is idle: the loop and the model hold some of it
        assert a["metrics"]["loop_idle_ms.train"]["value"] > 0.0
        assert a["metrics"]["model_idle_ms.train"]["value"] > 0.0
    for k in ("correct", "attempted", "failed", "checks"):
        assert a[k] == b[k], k
    old = {k: v for k, v in a["metrics"].items() if k not in NEW[cell]}
    assert set(old) == set(b["metrics"])
    for k in old:
        if not k.startswith("mfu."):  # host-clocked
            assert old[k] == b["metrics"][k], k


def test_a_port_without_the_recorder_has_no_slice(small_root):
    code = TRACED + """
from abstractgps_tpu_torch.utils import profiling
del profiling.recording  # as the port was before it had one
line = traced("svgp50k.train", 1e-4)
print(json.dumps(line))
"""
    res = run_python(small_root, code)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and "[spans]" not in res.stderr
    assert not set(NEW["svgp50k.train"]) & set(line["metrics"])
    assert "idle_share.train" in line["metrics"]
