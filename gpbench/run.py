"""Run one cell of the benchmark of ``abstractgps_tpu_torch``.

    python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (import, the kernels built or loaded, the data made on the card from
the seed, the cell's own shapes warmed) is timed as ``setup_s``; then the
traffic mix's generator drives the port for ``--seconds``; then the
port's state is freed and what the window produced is held against the
plain reference. With ``--trace 1`` the first part of the window runs under
``torch.profiler`` and the cell's per-layer metrics are reported instead
of its end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and, traced,
``breakdown``), and last ``checks``, each number compared with its limit.
The checks are also the last lines of standard error. A run with no CUDA
device, fewer devices than the cell asks for, or JAX or the JAX package
loaded exits non-zero and prints no result.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

import torch  # noqa: E402

from gpbench import compare, trace  # noqa: E402
from gpbench import spec as S  # noqa: E402

import abstractgps_tpu_torch  # noqa: E402,F401

_T_IMPORTED = time.perf_counter()

FORBIDDEN = ("jax", "jaxlib", "flax", "abstractgps_tpu")


class Run:
    """What one run carries from set-up through the window to the result."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, err=sys.stderr):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.err = device, err
        self.setup_s = None
        self.memory_peak = 0
        self.marks = {"import": _T_IMPORTED - _T_START}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, label: str):
        """Note how far set-up has come, for the set-up line on stderr."""
        self._sync()
        self.marks[label] = time.perf_counter() - _T_START

    def setup_done(self):
        self.mark("warm")
        self.setup_s = self.marks["warm"]

    def window_open(self):
        """The window starts: time the Python probe and note the host's
        counters, to say after it how fast the host ran."""
        self._probe0 = _python_probe_ms()
        self._host0 = _host_counters()

    def window_closed(self):
        self._sync()
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)
        self.host = _host_line(self._host0, _host_counters(), self._probe0, self.device)

    def free(self):
        """After the program's state is dropped: return its memory."""
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _host_counters() -> tuple:
    """(host clock, this process's CPU seconds)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return time.perf_counter(), ru.ru_utime + ru.ru_stime


def _python_probe_ms() -> float:
    """Median of five timings of a fixed pure-Python loop: the host's speed
    for the interpreter, read just before and after the window."""
    times = []
    for _ in range(5):
        t = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i * i
        times.append(time.perf_counter() - t)
    return sorted(times)[2] * 1e3


def _host_line(a: tuple, b: tuple, probe0: float, device) -> str:
    """How fast the host ran in the window: the CPUs this process kept busy,
    the Python probe before and after it; on a card, its clocks after it."""
    wall = b[0] - a[0]
    parts = [f"window {wall:.3f} s", f"this process {(b[1] - a[1]) / wall:.3f} CPUs",
             f"python probe {probe0:.3f} ms before, {_python_probe_ms():.3f} ms after"]
    if device.type == "cuda":
        try:
            q = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,power.draw,"
                 "clocks_throttle_reasons.active", "--format=csv,noheader",
                 f"--id={device.index or 0}"], capture_output=True, text=True, timeout=30)
            parts.append("card " + q.stdout.strip())
        except (OSError, subprocess.SubprocessError) as e:
            parts.append(f"nvidia-smi: {e}")
    return "; ".join(parts)


def forbidden_modules() -> list:
    """Modules whose top-level name, compared whole, is JAX's or the JAX
    package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _card_line(device) -> str:
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        limit = f"nvidia-smi: {e}"
    return (f"[device] {torch.cuda.get_device_name(device)}, {torch.cuda.device_count()} "
            f"visible; nvidia-smi: {limit.strip()}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")


def layer_metrics(cell, out: dict) -> dict:
    """Each per-layer metric the cell reports, from its reader; a reader
    that finds nothing to read leaves its metric out."""
    rec = dict(out["layer"], trace=out["trace"], config=cell.config, traffic=cell.traffic,
               counts=cell.counts())
    got = {}
    for m in cell.per_layer:
        value = S.load_module("metrics", m["name"]).read(rec)
        if value is not None:
            got[m["name"]] = {"value": value, "unit": m["unit"]}
    return got


def execute(argv=None, device=None, out=sys.stdout, err=sys.stderr) -> int:
    """Run a cell. ``device`` set skips the look for a card (tests on the
    CPU); the command line never sets it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = S.load_cell(args.workload)
    except S.SpecError as e:
        print(f"gpbench: {e}", file=err)
        return 2
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"gpbench: {args.workload} needs {cell.chips} CUDA device(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                  f"{torch.cuda.device_count()} visible", file=err)
            return 3
        device = torch.device("cuda", 0)
        torch.set_num_threads(1)  # one process, one host thread of CPU operators
        print(_card_line(device), file=err, flush=True)
        from abstractgps_tpu_torch.ops import cuda

        cuda.library()
    run = Run(cell, args.seed, args.seconds, bool(args.trace), device, err)
    run.mark("kernels")
    res = cell.generator().run(run)
    bad = forbidden_modules()
    if bad:
        print(f"gpbench: JAX or the JAX package was loaded: {bad}", file=err)
        return 4

    ok, checks = compare.verdict(res["numbers"], cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if args.trace:
        metrics = layer_metrics(cell, res)
    else:
        metrics = {k: {"value": v, "unit": units[k]} for k, v in res["end_to_end"].items()
                   if k in units}
        metrics["setup_s"] = {"value": run.setup_s, "unit": units["setup_s"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.memory_peak}
    line = {"correct": ok, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        rec = res["trace"]
        dev.update(busy_s=trace.busy_s(rec), window_s=rec.window_s)
        line["breakdown"] = trace.breakdown(rec)
    line["checks"] = checks
    marks = ", ".join(f"{k} {v:.3f}" for k, v in run.marks.items())
    print(f"[setup] {run.setup_s:.6f} s (seconds from start: {marks}); memory peak "
          f"{run.memory_peak} bytes", file=err)
    print(f"[host] {run.host}", file=err)
    for name, (value, limit) in checks.items():
        print(f"[check] {name} {value!r} limit {limit!r}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(execute())
