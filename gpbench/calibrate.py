"""Readings from which a cell's limits are set; the benchmark's own runs
never run this.

    python3 gpbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
        [--faults [<fault> ...]]

For each seed, in one process: a run of the cell as the benchmark makes
it, with a window of ``--seconds``, and the numbers that decide
``correct`` for the program as it is (sound); for the control, the plain
reference computed in TF32 (``numerics.TF32``) in the program's place on
the same inputs (the generator's ``control_numbers``); and for a run with
each fault that the cell can have planted underneath (``faults``; those
named after ``--faults``, where it is given). Prints
one JSON line per seed and reading, with its verdict against the cell's
committed limits, then the largest sound reading and the least reading of
the control and of each fault, per number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

import torch  # noqa: E402

from gpbench import compare, faults  # noqa: E402
from gpbench import run as R  # noqa: E402
from gpbench import spec as S  # noqa: E402


def _run(cell, seed: int, seconds: float, device) -> dict:
    return cell.generator().run(R.Run(cell, seed, seconds, False, device))


def readings(cell, seed: int, seconds: float, device, kinds=None) -> dict:
    """{reading: numbers} of one seed: "sound", "control" and each fault (of
    ``kinds`` where it is given)."""
    res = _run(cell, seed, seconds, device)
    out = {"sound": res["numbers"],
           "control": cell.generator().control_numbers(cell, res["judged"])}
    del res
    for name in faults.faults_of(cell) if kinds is None else kinds:
        with faults.planted(cell, name):
            out[name] = _run(cell, seed, seconds, device)["numbers"]
    return out


def judged(numbers: dict, limits: dict) -> bool:
    """The verdict on ``numbers`` against those of ``limits`` it has."""
    return compare.verdict(numbers, {k: v for k, v in limits.items() if k in numbers})[0]


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=None)
    args = ap.parse_args(argv)
    cell = S.load_cell(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("calibrate: no CUDA device", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    table: dict = {}
    for seed in args.seeds:
        for kind, numbers in readings(cell, seed, args.seconds, device, args.faults).items():
            print(json.dumps({"cell": cell.name, "seed": seed, "reading": kind,
                              "correct": judged(numbers, cell.limits), **numbers}), flush=True)
            for k, v in numbers.items():
                table.setdefault(kind, {}).setdefault(k, []).append(v)
    summary = {kind: {k: (max(v) if kind == "sound" else min(v)) for k, v in nums.items()}
               for kind, nums in table.items()}
    print(json.dumps({"cell": cell.name, "seeds": args.seeds,
                      "largest sound, least control and faults": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
