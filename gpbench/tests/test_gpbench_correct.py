"""What decides ``correct``, on the CPU at small sizes: the plain float64
references agree with the port; the control (the reference computed in
TF32 in the program's place) and references with a seeded fault (a wrong
noise, a dropped term) fail the committed limits; and a whole run with
the timed path broken underneath by each fault its cell can have comes
out not correct."""

from __future__ import annotations

import json

import pytest

from gpbench.tests.conftest import CPU_RUN, run_python

CELLS = ("exact8k.train", "svgp50k.train", "exact8k.predict", "svgp50k.predict")

# SVGP prediction is no cell of BENCHMARK.json (its host-clocked latency
# spreads too widely, PERF.md), but its path stays ready to come back as
# data: the tests add its cell to the small copy, with the limits that
# calibration on the card set for it.
SVGP_PREDICT = {"name": "svgp50k.predict", "config": "svgp-seard-n50000-m512-d8",
                "traffic": "predict_ragged", "chips": 1,
                "why": "large-n serving from an SVGP: the ragged queries of 1-4096 points"}
SVGP_PREDICT_LIMITS = {"mean_err": 4e-4, "var_err": 6e-4, "nonfinite": 0}


@pytest.fixture
def cells_root(small_root):
    """The small copy, with the SVGP prediction cell added."""
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    if SVGP_PREDICT["name"] not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append(SVGP_PREDICT)
        (small_root / "BENCHMARK.json").write_text(json.dumps(bench))
        (small_root / "gpbench" / "limits" / f"{SVGP_PREDICT['name']}.json").write_text(
            json.dumps(SVGP_PREDICT_LIMITS))
    return small_root

READINGS = CPU_RUN + """
from gpbench import calibrate
cell = S.load_cell(CELL)
out = {}
for seed in (2147483657, 3):
    for kind, numbers in calibrate.readings(cell, seed, 0.3, torch.device("cpu")).items():
        out.setdefault(kind, []).append(calibrate.judged(numbers, cell.limits))
print(json.dumps(out))
"""


def _readings(root, cell):
    res = run_python(root, READINGS.replace("CELL", repr(cell)))
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_passes_and_control_and_faults_fail(cells_root, cell):
    got = _readings(cells_root, cell)
    assert got["sound"] == [True, True]
    assert got["control"] == [False, False]
    faults = [k for k in got if k not in ("sound", "control")]
    assert faults and all(got[k] == [False, False] for k in faults)


SEEDED = CPU_RUN + """
from gpbench import spec as S, compare
from gpbench.calibrate import judged
from gpbench.generators import train, predict
from gpbench.numerics import F64
from gpbench.reference import exact_gp as ref
import math
cell = S.load_cell(CELL)
dev = torch.device("cpu")
out = {}
if cell.traffic["generator"] == "train":
    prob, _, prog = train.setup(cell, 11, dev)
    inputs = prob.reference_inputs(cell.traffic["first_steps"])
    wrong = dict(inputs, start=dict(inputs["start"]))
    wrong["start"]["noise"] = wrong["start"]["noise"] * 1.1
    nlml = ref.nlml
    out["wrong noise"] = judged(compare.train_numbers(
        prog, ref.train_steps(cell.config, cell.traffic, wrong)), cell.limits)
    def no_logdet(cfg, raw, x, y, prec=F64):
        full = nlml(cfg, raw, x, y, prec)
        s2, ell, noise = (ref.softplus(raw[k]) for k in ("s2", "ell", "noise"))
        K = ref.kernel(cfg["kernel"], ref.sqdist(prec.cast(x), prec.cast(x), prec), s2, ell)
        L = torch.linalg.cholesky(K + noise * torch.eye(K.shape[0], dtype=K.dtype))
        return full - torch.log(torch.diagonal(L)).sum()
    ref.nlml = no_logdet
    out["dropped term"] = judged(compare.train_numbers(
        prog, ref.train_steps(cell.config, cell.traffic, inputs)), cell.limits)
else:
    su = predict.Setup(cell, 11, dev)
    sample = predict.Sample(cell.traffic["sample_queries"], 11)
    for _ in range(len(su.sizes)):
        sample.offer(su.next())
    wrong = dict(su.ref_inputs, theta=dict(su.ref_inputs["theta"]))
    wrong["theta"]["noise"] = wrong["theta"]["noise"] * 1.1
    su.ref_inputs = wrong
    out["wrong noise"] = judged(predict.compare_sample(cell, su, sample.answers()),
                              cell.limits)
print(json.dumps(out))
"""


@pytest.mark.parametrize("cell", ("exact8k.train", "exact8k.predict"))
def test_a_seeded_fault_in_the_reference_fails(small_root, cell):
    res = run_python(small_root, SEEDED.replace("CELL", repr(cell)))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got and not any(got.values()), got


RUNS = CPU_RUN + """
out = {"sound": go(CELL)["correct"]}
for f in faults.faults_of(S.load_cell(CELL)):
    out[f] = go(CELL, fault=f)["correct"]
print(json.dumps(out))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_with_the_timed_path_broken_is_not_correct(cells_root, cell):
    res = run_python(cells_root, RUNS.replace("CELL", repr(cell)))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got.pop("sound") is True
    assert got and not any(got.values()), got
