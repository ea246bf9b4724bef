"""Nothing the benchmark loads imports JAX or the JAX package, and the
references import nothing of the program: top-level module names compared
whole (the port's name begins with the JAX package's)."""

from __future__ import annotations

import json

from gpbench.tests.conftest import REPO, run_python

LOAD_ALL = """
import json, sys
from gpbench import spec as S
import gpbench.run, gpbench.calibrate, gpbench.faults
for kind in ("families", "generators", "reference", "counts", "metrics"):
    for p in sorted((S.CODE_DIR / kind).glob("*.py")):
        if p.stem != "__init__":
            S.load_module(kind, p.stem)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

LOAD_REFERENCES = """
import json, sys
from gpbench import spec as S
for p in sorted((S.CODE_DIR / "reference").glob("*.py")):
    if p.stem != "__init__":
        S.load_module("reference", p.stem)
import gpbench.compare, gpbench.numerics
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _tops(code):
    res = run_python(REPO, code)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    tops = _tops(LOAD_ALL)
    assert "abstractgps_tpu_torch" in tops and "gpbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "abstractgps_tpu"}


def test_the_references_load_nothing_of_the_program():
    tops = _tops(LOAD_REFERENCES)
    assert not tops & {"jax", "jaxlib", "flax", "abstractgps_tpu", "abstractgps_tpu_torch"}


def test_run_refuses_to_report_with_jax_loaded(monkeypatch):
    import sys
    import types

    from gpbench import run as R

    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "abstractgps_tpu_torchx", types.ModuleType("x"))
    assert R.forbidden_modules() == ["jax.numpy"]
