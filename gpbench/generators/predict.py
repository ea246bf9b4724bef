"""Closed-loop prediction: one caller queries ``mean_and_var(x*)`` of a
posterior built once in set-up, and copies both results to the host
before the next query. A query's latency runs from the call to both
results on the host.

Query sizes: a fixed multiset, the ``count`` quantiles of the log-uniform
law on [``low``, ``high``] (rounded), the same for every seed; each cycle
through it is a new order drawn from the seed. x* is a contiguous slice,
at an offset drawn from the seed, of a pool of ``pool_points`` inputs
drawn as the training inputs are. Set-up warms each distinct size once.

``sample_queries`` of the answers, drawn from the seed as they come, and
the first of the largest are kept; after the window they are held against
the plain reference.

Traffic parameters: ``sizes`` {low, high, count}, ``pool_points``,
``sample_queries``."""

from __future__ import annotations

import array
import gc
import math
import time

import numpy as np
import torch

from gpbench import compare, trace
from gpbench.numerics import F64, TF32

# the faults a prediction cell can have (``gpbench.faults``)
FAULTS = ("altered_answer",)


def fault_patches(name: str) -> list:
    """No part of a fault lies in the query loop itself."""
    return []


def query_sizes(spec: dict) -> list:
    lo, hi, count = math.log(spec["low"]), math.log(spec["high"]), spec["count"]
    return [int(round(math.exp(lo + (hi - lo) * (k + 0.5) / count))) for k in range(count)]


def schedule(sizes: list, pool: int, rng: np.random.Generator):
    """Endless (q, offset) pairs: each cycle a new order of ``sizes``."""
    while True:
        for q in rng.permutation(sizes):
            yield int(q), int(rng.integers(0, pool - q + 1))


class Setup:
    """The posterior, the query pool and schedule of one seed, the cell's
    sizes warmed."""

    def __init__(self, cell, seed: int, device, mark=lambda label: None):
        fam, cfg, traffic = cell.family(), cell.config, cell.traffic
        gen = torch.Generator(device=device).manual_seed(seed)
        data = fam.make_data(cfg, gen)
        self.model, self.ref_inputs, self.prior_var = fam.predictor(cfg, data, gen)
        self.pool = fam.draw_inputs(cfg, gen, traffic["pool_points"])
        self.sizes = query_sizes(traffic["sizes"])
        self.queries = schedule(self.sizes, self.pool.shape[0], np.random.default_rng(seed))
        mark("data")
        for q in sorted(set(self.sizes)):
            self.query(q, 0)

    def query(self, q: int, off: int):
        """(seconds, mean, var) of one query, both results on the host. A
        serving caller needs no gradient: the call runs under no_grad."""
        t = time.perf_counter()
        with torch.no_grad():
            mu, var = self.model.mean_and_var(self.pool[off:off + q])
            mu, var = mu.cpu(), var.cpu()
        return time.perf_counter() - t, mu, var

    def next(self) -> tuple:
        q, off = next(self.queries)
        return (q, off, *self.query(q, off))


class Sample:
    """The answers kept for the comparison: a uniform sample of ``count`` of
    them, drawn from the seed as they come (reservoir sampling), and the
    first of the largest. The window keeps no other answer."""

    def __init__(self, count: int, seed: int):
        self.count, self.rng = count, np.random.default_rng([seed, 1])
        self.kept, self.largest, self.seen = [], None, 0

    def offer(self, answer: tuple) -> None:
        """``answer``: (q, offset, seconds, mean, var)."""
        if len(self.kept) < self.count:
            self.kept.append(answer)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.count:
                self.kept[j] = answer
        if self.largest is None or answer[0] > self.largest[0]:
            self.largest = answer
        self.seen += 1

    def answers(self) -> list:
        return self.kept + [self.largest]


def compare_sample(cell, su: Setup, answers: list, prec=F64) -> dict:
    """The numbers of the kept answers against the reference computed in
    ``prec`` (float64; the control's precision for the control)."""
    ref = cell.reference().Posterior(cell.config, su.ref_inputs, prec)
    refs = [ref.mean_and_var(su.pool[off:off + q]) for q, off, *_ in answers]
    return compare.predict_numbers([a[3:] for a in answers], refs, su.prior_var)


def control_numbers(cell, judged: dict) -> dict:
    """The numbers of the control, the reference computed in TF32 in the
    program's place, on the queries whose answers a run kept."""
    su, answers = judged["setup"], judged["answers"]
    ctrl = cell.reference().Posterior(cell.config, su.ref_inputs, TF32)
    as_program = [(q, off, 0.0, *(t.cpu() for t in ctrl.mean_and_var(su.pool[off:off + q])))
                  for q, off, *_ in answers]
    return compare_sample(cell, su, as_program)


def run(ctx) -> dict:
    cell = ctx.cell
    su = Setup(cell, ctx.seed, ctx.device, ctx.mark)
    ctx.setup_done()

    sample = Sample(cell.traffic["sample_queries"], ctx.seed)
    sizes, seconds = array.array("l"), array.array("d")  # of the timed queries
    bad = 0

    def one():
        nonlocal bad
        answer = su.next()
        sample.offer(answer)
        bad += not (bool(torch.isfinite(answer[3]).all()) and bool(torch.isfinite(answer[4]).all()))
        return answer

    rec, traced = None, len(su.sizes) if ctx.trace else 0
    if ctx.trace:
        with trace.traced() as box:
            traced_sizes = [one()[0] for _ in range(traced)]
        rec = box[0]
    gen2 = gc.get_stats()[2]["collections"]
    ctx.window_open()
    t0 = time.perf_counter()
    while not sizes or time.perf_counter() - t0 < ctx.seconds:
        q, _, dt, *_ = one()
        sizes.append(q)
        seconds.append(dt)
    t1 = time.perf_counter()
    gen2 = gc.get_stats()[2]["collections"] - gen2
    ctx.window_closed()
    del su.model
    ctx.free()

    answers = sample.answers()
    numbers = dict(compare_sample(cell, su, answers), nonfinite=bad)
    lat_ms = np.asarray(seconds) * 1e3
    fifth = max(1, len(lat_ms) // 5)
    points = sum(sizes)
    wide = sum(1 for a in answers if a[0] >= 256)
    print(f"[window] {len(sizes)} queries, {points} points in {t1 - t0:.6f} s ({traced} traced "
          f"before it; {gen2} full garbage collections in it); latency median "
          f"{np.median(lat_ms):.6f} ms (first fifth {np.median(lat_ms[:fifth]):.6f}, last "
          f"fifth {np.median(lat_ms[-fifth:]):.6f}), p95 {np.percentile(lat_ms, 95):.6f} ms; "
          f"compared "
          f"{len(answers)} answers ({wide} with q >= 256, largest q {answers[-1][0]})",
          file=ctx.err, flush=True)
    return {"attempted": traced + len(sizes), "failed": bad,
            "end_to_end": {"predict_points_per_s": points / (t1 - t0),
                           "predict_p95_ms": float(np.percentile(lat_ms, 95))},
            "numbers": numbers, "judged": {"setup": su, "answers": answers}, "trace": rec,
            "layer": {"traced_units": traced_sizes if ctx.trace else [],
                      "untraced_units": list(sizes), "untraced_s": float(sum(seconds))}}
