"""The matrix-free cell ``cg32k.train`` at its CPU size (``small/``): sound
runs pass and the control and every fault fail; its two readers on a
small traced run; a port without the pivot order the reference needs
stops the cell at once; the operation counts by hand."""

from __future__ import annotations

import json

import pytest

from gpbench import peaks
from gpbench.counts import cg_gp
from gpbench.tests.conftest import CPU_RUN, run_python
from gpbench.tests.test_gpbench_correct import RUNS, _readings
from gpbench.tests.test_gpbench_spans import TRACED

CELL = "cg32k.train"
NEW = ("cg_converged_matvecs_per_step.train", "cg_gram_panel_roofline.train")


def test_sound_passes_and_control_and_faults_fail(small_root):
    got = _readings(small_root, CELL)
    assert got["sound"] == [True, True]
    assert got["control"] == [False, False]
    faults = [k for k in got if k not in ("sound", "control")]
    assert sorted(faults) == ["altered_answer", "frozen_step", "half_batch"]
    assert all(got[k] == [False, False] for k in faults)


def test_a_run_with_the_timed_path_broken_is_not_correct(small_root):
    res = run_python(small_root, RUNS.replace("CELL", repr(CELL)))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got.pop("sound") is True
    assert got and not any(got.values()), got


def test_the_readers_on_a_small_traced_run(small_root):
    res = run_python(small_root, TRACED + f"""
print(json.dumps(traced({CELL!r}, 1e-4)))
""")
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and "[spans] slice:" in res.stderr
    m = line["metrics"]
    # every step of the slice solves with 256 matvecs; at n = 384 each column
    # converges in far fewer, so most ran after every column had frozen
    assert 128 < m["cg_converged_matvecs_per_step.train"]["value"] <= 256
    # the CPU's trace holds no gram-tile launch, and the small size is on the
    # dense path: no panel to read
    assert "cg_gram_panel_roofline.train" not in m
    for name in ("loop_idle_ms.train", "model_idle_ms.train", "ops_idle_ms.train"):
        assert m[name]["value"] >= 0.0
    assert "library.cg_matvec 256.000" in res.stderr


def test_a_port_without_the_pivot_order_stops_the_cell_at_once(small_root):
    res = run_python(small_root, CPU_RUN + f"""
from abstractgps_tpu_torch.ops import pivchol
del pivchol.pivoted_cholesky_with_pivots  # as the port was before it gave them
go({CELL!r})
""", timeout=120)
    assert res.returncode != 0
    assert "pivoted_cholesky_with_pivots" in res.stderr
    assert res.stdout.strip() == ""


def test_cg_counts_by_hand():
    cfg = {"n": 4, "d": 2, "kernel": "matern32", "model_iters": 3,
           "cg": {"num_probes": 2, "precond_rank": 1, "panel": 2, "max_dense_n": 2}}
    # a matvec: the map over 16 entries, (6 + 12) each, and 2·16·(1 + 2)
    assert cg_gp.matvec_flops(cfg) == 16 * 18 + 96
    # the pivoted Cholesky: 1 column of 4 entries and 4·1² of updates; the VJP
    # over 10 lower-triangle pairs, cotangent 6 and Matérn-3/2's 6, epilogue
    # 1, and 16 ordered x̄ entries of 3·2
    vjp = 10 * (6 + 6 + 6 + 1) + 16 * 6
    assert peaks.sweep_flops(4, 4, 2, 2, True, 6, 1) == vjp
    assert cg_gp.step_flops(cfg, {}) == pytest.approx(3 * (16 * 18 + 96) + 4 * 18 + 4 + vjp)
    assert cg_gp.gram_panel_launch(cfg) == peaks.gram_tile_cost(2, 4, 2)
    assert cg_gp.gram_panel_launch(dict(cfg, n=5)) == peaks.gram_tile_cost(2, 6, 2)  # padded
    assert cg_gp.gram_panel_launch(dict(cfg, n=2)) is None  # the dense path
    big = {"n": 32768, "d": 8, "kernel": "matern32", "model_iters": 1,
           "cg": {"num_probes": 32, "precond_rank": 64, "panel": 1024, "max_dense_n": 8192}}
    assert cg_gp.matvec_flops(big) == pytest.approx(1.10e11, rel=0.01)
    nbytes, ops = cg_gp.gram_panel_launch(big)
    assert peaks.bound_s(nbytes, ops) * 1e3 == pytest.approx(0.0404, rel=0.01)
