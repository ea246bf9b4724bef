"""The harness finds a configuration, a traffic mix and a per-layer metric
added as new files and entries, with no existing file edited; and every
metric entry is well formed."""

from __future__ import annotations

import json
import shutil

from gpbench.tests.conftest import CODE, CPU_RUN, REPO, make_small_root, run_python


def test_new_config_traffic_and_metric_are_found_as_new_files(tmp_path):
    full = tmp_path / "full"
    shutil.copytree(CODE, full / "gpbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", full / "BENCHMARK.json")
    code = full / "gpbench"
    before = {p: p.read_bytes() for p in full.rglob("*") if p.is_file()}
    # a configuration: a new file, its family's code reused
    shutil.copy(code / "configs" / "exact-matern32-n8192-d8.json",
                code / "configs" / "exact-matern52-n512-d3.json")
    cfg = json.loads((code / "configs" / "exact-matern52-n512-d3.json").read_text())
    cfg.update(name="exact-matern52-n512-d3", kernel="matern52", n=512, d=3)
    (code / "configs" / "exact-matern52-n512-d3.json").write_text(json.dumps(cfg))
    # its CPU size for the tests: a new file too
    (code / "tests" / "small" / "configs" / "exact-matern52-n512-d3.json").write_text(
        json.dumps({"n": 256}))
    # a traffic mix: a data file for the general generator
    (code / "traffic" / "mle_adam_short.json").write_text(json.dumps(
        {"generator": "train", "steps_per_call": 2, "learning_rate": 0.02, "first_steps": 3}))
    (code / "limits" / "exact512.short.json").write_text(
        (code / "limits" / "exact8k.train.json").read_text())
    # a per-layer metric: a reader of its own
    (code / "metrics" / "steps_untraced.train.py").write_text(
        "def read(rec):\n    return float(len(rec['untraced_units'])) or None\n")
    bench = json.loads((full / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                             "file": "gpbench/configs/exact-matern52-n512-d3.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "exact512.short", "config": cfg["name"],
                               "traffic": "mle_adam_short", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_untraced.train", "unit": "steps",
                               "better": "higher", "source": "host_clock", "layer": "models",
                               "moves": "train_steps_per_s", "workloads": ["exact512.short"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_steps_per_s":
            m["workloads"].append("exact512.short")
    (full / "BENCHMARK.json").write_text(json.dumps(bench))
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert changed == [full / "BENCHMARK.json"]

    small_root = make_small_root(tmp_path / "small", src=full)
    res = run_python(small_root, CPU_RUN + """
from gpbench import spec as S
cell = S.load_cell("exact512.short")
line = go("exact512.short")
reader = S.load_module("metrics", "steps_untraced.train")
print(json.dumps({"line": line, "kernel": cell.config["kernel"], "n": cell.config["n"],
                  "traffic": cell.traffic, "per_layer": [m["name"] for m in cell.per_layer],
                  "read": reader.read({"untraced_units": [1, 1, 1]})}))
""")
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["kernel"] == "matern52" and got["n"] == 256
    assert got["traffic"]["steps_per_call"] == 2
    assert "steps_untraced.train" in got["per_layer"]
    assert got["read"] == 3.0
    line = got["line"]
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"train_steps_per_s", "setup_s"}


def test_benchmark_entries_match_their_files():
    from gpbench import spec as S

    bench = json.loads((S.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = S.load_cell(w["name"])
        assert cell.family() and cell.generator() and cell.reference() and cell.counts()
        assert cell.per_layer, w["name"]
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        for m in cell.per_layer:
            assert callable(S.load_module("metrics", m["name"]).read)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
    for c in bench["configs"]:
        cfg = json.loads((S.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_a_per_layer_metric_without_workloads_is_refused(small_root):
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    del bench["per_layer"][0]["workloads"]
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_python(small_root, """
from gpbench import spec as S
try:
    S.load_cell("exact8k.train")
except S.SpecError as e:
    print("refused:", e)
""")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "lists no workloads" in res.stdout
