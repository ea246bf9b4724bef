"""The temporal cell ``markov1m.train`` at its CPU size (``small/``: 10 000
timestamps, so the scan runs three chunks and two carries): sound runs
pass and the control and every fault fail; its two readers on a small
traced run; a port without the Markov spans and counter leaves both out
of the line and runs on; the operation count by hand."""

from __future__ import annotations

import json

from gpbench.counts import markov_gp
from gpbench.tests.conftest import run_python
from gpbench.tests.test_gpbench_correct import RUNS, _readings
from gpbench.tests.test_gpbench_spans import TRACED

CELL = "markov1m.train"
NEW = ("markov_carry_idle_ms.train", "markov_carry_combines_per_step.train")


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
    # one chunked scan a step's loss, ⌈10 000 / 4096⌉ − 1 combines on the host;
    # autograd's backward of the loop makes none
    assert m["markov_carry_combines_per_step.train"]["value"] == 2.0
    assert m["markov_carry_idle_ms.train"]["value"] >= 0.0
    for name in ("loop_idle_ms.train", "model_idle_ms.train", "ops_idle_ms.train"):
        assert m[name]["value"] >= 0.0
    assert "library.markov_carry_combine 2.000" in res.stderr


def test_a_port_without_the_markov_spans_leaves_the_readers_out(small_root):
    res = run_python(small_root, TRACED + f"""
import contextlib
from abstractgps_tpu_torch.models import markov
from abstractgps_tpu_torch.utils import profiling
# as the port was before it had them
del profiling.LIBRARY_CALLS["markov_carry_combine"]
markov.LIBRARY_CALLS = {{"markov_carry_combine": 0}}
markov.span = lambda name: contextlib.nullcontext()
print(json.dumps(traced({CELL!r}, 1e-4)))
""")
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert not set(NEW) & set(line["metrics"])
    assert "ops_idle_ms.train" in line["metrics"]


def test_markov_counts_by_hand():
    # a timestamp's forward work: the transition 9, Q 20, the prediction 30,
    # the update 14, the term 6; the gradient twice that again
    assert markov_gp.FILTER_STEP_FLOPS == 79
    assert markov_gp.step_flops({"n": 10}, {}) == 3 * 79 * 10
    assert markov_gp.step_flops({"n": 10 ** 6}, {}) == 2.37e8
