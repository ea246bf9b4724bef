"""Find every piece of a cell by the names in ``BENCHMARK.json``.

The benchmark's code directory is the one that holds this file; the root
of the checkout is its parent, where ``BENCHMARK.json`` lies. Data files
are JSON: a configuration's ``file`` (a path from the root), a traffic
mix under ``traffic/<traffic>.json`` and a cell's limits under
``limits/<cell>.json``. Code is found by name: the family of a
configuration under ``families/``, ``reference/`` and ``counts/``, the
generator a traffic mix names under ``generators/``, and each per-layer
metric's reader under ``metrics/<metric>.py``. Adding a cell, a mix, a
configuration or a metric adds files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

CODE_DIR = Path(__file__).resolve().parent
ROOT = CODE_DIR.parent


class SpecError(RuntimeError):
    """A cell, file or module that ``BENCHMARK.json`` names is missing."""


def _json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing file {path}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the code directory, loaded from its
    file (a metric's name may hold dots)."""
    path = CODE_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"missing module {path}")
    mod_name = f"gpbench.{kind}." + "".join(c if c.isalnum() else "_" for c in name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config: dict        # the configuration's file, as it is run
    traffic: dict       # the traffic mix's data file
    limits: dict        # the cell's limits on the numbers that decide `correct`
    end_to_end: list    # the end-to-end metric entries this cell reports
    per_layer: list     # the per-layer metric entries this cell reports

    def family(self):
        return load_module("families", self.config["family"])

    def generator(self):
        return load_module("generators", self.traffic["generator"])

    def reference(self):
        return load_module("reference", self.config["family"])

    def counts(self):
        return load_module("counts", self.config["family"])


def _reports(metric: dict, cell: str) -> bool:
    """A metric entry reports in ``cell``: an end-to-end one listed there or
    with no ``workloads`` key, a per-layer one listed there."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        raise SpecError(f"per-layer metric {metric['name']!r} lists no workloads")
    return True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name!r} names no known config {w['config']!r}")
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(CODE_DIR / "traffic" / f"{w['traffic']}.json")
    limits = _json(CODE_DIR / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer)
