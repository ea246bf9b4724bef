"""A run that finds no card, or fewer than its cell asks for, exits with an
error and prints no result: it never falls back to the CPU. A directory
with only the benchmark's files (no port beside it) fails the same way."""

from __future__ import annotations

import shutil
import subprocess
import sys

from gpbench.tests.conftest import REPO


def _run(cwd, env_extra=None):
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "gpbench/run.py", "--workload", "exact8k.train",
                           "--seed", "2147483655", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=300)


def test_no_card_no_result():
    res = _run(REPO)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA device" in res.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(REPO / "gpbench", tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = _run(tmp_path, {"PYTHONPATH": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
