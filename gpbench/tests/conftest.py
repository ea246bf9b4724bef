"""Fixtures of the benchmark's own tests: a copy of the benchmark at small
sizes, and a fresh interpreter to drive it, so the copy's modules (and
nothing the test process loaded) are what runs.

The small sizes are data: ``small/configs/<config>.json`` and
``small/traffic/<traffic>.json`` beside this file hold the keys that a
configuration or a traffic mix changes for the CPU; one that has no such
file runs as it is."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
CODE = REPO / "gpbench"


def _cut(path: Path, small: Path) -> None:
    """Update the JSON object in ``path`` with the one in ``small``, if any."""
    if small.is_file():
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        **json.loads(small.read_text()))))


def make_small_root(dest: Path, src: Path = REPO) -> Path:
    """A checkout-like directory: ``src``'s BENCHMARK.json and a copy of its
    gpbench/ whose configurations and traffic mixes are cut to CPU sizes."""
    shutil.copytree(src / "gpbench", dest / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(src / "BENCHMARK.json", dest / "BENCHMARK.json")
    small = dest / "gpbench" / "tests" / "small"
    for c in json.loads((dest / "BENCHMARK.json").read_text())["configs"]:
        _cut(dest / c["file"], small / "configs" / f"{c['name']}.json")
    for path in (dest / "gpbench" / "traffic").glob("*.json"):
        _cut(path, small / "traffic" / path.name)
    return dest


@pytest.fixture
def small_root(tmp_path):
    return make_small_root(tmp_path / "root")


def run_python(root: Path, code: str, timeout: float = 600, env=None):
    """Run ``code`` in a fresh interpreter with ``root`` (a benchmark copy)
    first on the path and the port after it, on the CPU with few threads."""
    prelude = (f"import sys; sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]\n"
               "import torch; torch.set_num_threads(2)\n")
    full_env = dict(os.environ, **(env or {}))
    return subprocess.run([sys.executable, "-c", prelude + code], capture_output=True,
                          text=True, timeout=timeout, cwd=root, env=full_env)


CPU_RUN = """
import json
import abstractgps_tpu_torch as agt
agt.set_default_device("cpu")
from gpbench import run as R
from gpbench import faults
from gpbench import spec as S
out = {}
def go(cell, seed=2147483653, fault=None, seconds=0.5):
    import contextlib, io
    buf = io.StringIO()
    ctx = faults.planted(S.load_cell(cell), fault) if fault else contextlib.nullcontext()
    with ctx:
        rc = R.execute(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)],
                       device=torch.device("cpu"), out=buf, err=io.StringIO())
    assert rc == 0, rc
    return json.loads(buf.getvalue().strip().splitlines()[-1])
"""
