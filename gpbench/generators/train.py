"""Closed-loop training: one caller calls ``fit`` again and again, each call
``steps_per_call`` Adam steps at ``learning_rate`` that continue from the
last call's parameters and end in a host read of the call's loss history.
Adam's moments restart with each call, so every timed step is whole.

Set-up drives the same problem through the same call for its first
``first_steps`` steps, keeping the gradient the optimizer got at the first
and the rows each step read, and hands its parameters to the window. The
window ends with the call that crosses ``--seconds``. Of its last call it
keeps the point the call started from, the loss the call recorded first,
the gradient the optimizer got at its first step and that step's rows.

Traffic parameters: ``steps_per_call``, ``learning_rate``, ``first_steps``,
and the family's own (``batch`` for a minibatched family)."""

from __future__ import annotations

import contextlib
import gc
import math
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

import abstractgps_tpu_torch as agt
import abstractgps_tpu_torch.params as P

from gpbench import compare, trace
from gpbench.numerics import F64, TF32

# the faults a training cell can have (``gpbench.faults``)
FAULTS = ("frozen_step", "half_batch", "altered_answer")


def fault_patches(name: str) -> list:
    """The parts of fault ``name`` that lie in the loop: a frozen step skips
    Adam's update."""
    if name == "frozen_step":
        import torch.optim.adam as adam_mod

        return [(adam_mod, "adam", lambda *args, **kwargs: None)]
    return []


class _FirstGrad:
    """An optimizer pre-step hook: once armed, it keeps the gradients the
    optimizer gets at its next step."""

    def __init__(self):
        self.armed, self.grads = False, None

    def __call__(self, opt, args, kwargs):
        if self.armed:
            self.armed = False
            self.grads = [p.grad.detach().clone() for g in opt.param_groups
                          for p in g["params"]]


@contextlib.contextmanager
def _first_grads():
    grab = _FirstGrad()
    hook = register_optimizer_step_pre_hook(grab)
    try:
        yield grab
    finally:
        hook.remove()


def _raw(theta, names) -> dict:
    return dict(zip(names, (t.detach() for t in P.leaves(theta))))


def _first_steps(prob, steps: int, lr: float) -> tuple:
    """(the parameters after the first steps through ``fit``, the losses, the
    gradient each leaf had when the optimizer took its first step, and each
    leaf's change)."""
    prob.record(True)
    try:
        with _first_grads() as grab:
            grab.armed = True
            res = agt.fit(prob.loss, prob.theta0, num_steps=steps, learning_rate=lr)
        losses = res.history.cpu().tolist()
    finally:
        prob.record(False)
    names = sorted(prob.theta0)
    a, b = _raw(prob.theta0, names), _raw(res.params, names)
    return res.params, {"losses": losses, "grad1": dict(zip(names, grab.grads)),
                        "delta": {k: b[k] - a[k] for k in names}}


def setup(cell, seed: int, device, mark=lambda label: None):
    """(the problem, its parameters after the first steps, what the program
    produced in them) of one seed."""
    fam, cfg, traffic = cell.family(), cell.config, cell.traffic
    gen = torch.Generator(device=device).manual_seed(seed)
    prob = fam.TrainProblem(cfg, traffic, fam.make_data(cfg, gen), gen)
    mark("data")
    theta, prog = _first_steps(prob, traffic["first_steps"], traffic["learning_rate"])
    return prob, theta, prog


def reference(cell, inputs: dict, prec=F64) -> dict:
    """The reference's steps from ``inputs`` (the family's), in ``prec``."""
    return cell.reference().train_steps(cell.config, cell.traffic, inputs, prec)


def _numbers(cell, judged: dict, control: bool = False) -> dict:
    """The numbers of what the program produced (``judged``) against the
    float64 reference; with ``control``, of the control in its place."""
    refs = {k: reference(cell, judged[k + "_inputs"]) for k in ("first", "point")}
    if control:
        c = {k: _control(cell, judged[k + "_inputs"]) for k in ("first", "point")}
        judged = dict(judged, first=c["first"], point=c["point"] and {
            "loss": c["point"]["losses"][0], "grad": c["point"]["grad1"]})
    first = (compare.train_numbers(judged["first"], refs["first"]) if judged["first"]
             else dict.fromkeys(("loss_rel", "loss1_rel", "grad1_rel", "delta_rel",
                                   "delta_median_rel"), math.inf))
    point = (compare.point_numbers(judged["point"], refs["point"], refs["first"])
             if judged["point"] else dict.fromkeys(("window_loss_gap", "window_grad_gap"),
                                                   math.inf))
    return dict(first, **point)


def _control(cell, inputs: dict):
    """The reference in TF32 from ``inputs``; None where it fails (a factor
    that is not positive definite): a control that crashes has failed."""
    try:
        return reference(cell, inputs, TF32)
    except torch.linalg.LinAlgError:
        return None


def control_numbers(cell, judged: dict) -> dict:
    """The numbers of the control, the reference computed in TF32 in the
    program's place from the same inputs, at a run's first steps and its
    last call's point."""
    return _numbers(cell, judged, control=True)


def run(ctx) -> dict:
    with _first_grads() as grab:
        return _run(ctx, grab)


def _run(ctx, grab) -> dict:
    cell = ctx.cell
    traffic = cell.traffic
    lr, chunk = traffic["learning_rate"], traffic["steps_per_call"]
    prob, theta, prog = setup(cell, ctx.seed, ctx.device, ctx.mark)
    names = sorted(prob.theta0)
    ctx.setup_done()

    def call(th):
        prob.mark_call()
        grab.armed = True
        res = agt.fit(prob.loss, th, num_steps=chunk, learning_rate=lr)
        hist = res.history.cpu()
        return res.params, hist, int((~torch.isfinite(hist)).sum())

    steps = nonfinite = 0
    rec, traced = None, chunk if ctx.trace else 0
    if ctx.trace:
        with trace.traced() as box:
            theta, _, nonfinite = call(theta)
        rec, steps = box[0], chunk
    gen2 = gc.get_stats()[2]["collections"]
    ctx.window_open()
    t0 = time.perf_counter()
    ends = [t0]
    while steps == traced or ends[-1] - t0 < ctx.seconds:
        start = theta
        theta, hist, bad = call(theta)
        steps, nonfinite = steps + chunk, nonfinite + bad
        ends.append(time.perf_counter())
    t1 = ends[-1]
    gen2 = gc.get_stats()[2]["collections"] - gen2
    ctx.window_closed()
    judged = {"first": prog, "first_inputs": prob.reference_inputs(traffic["first_steps"]),
              "point": {"loss": float(hist[0]), "grad": dict(zip(names, grab.grads))},
              "point_inputs": prob.point_inputs(_raw(start, names))}
    del theta, start, prob.loss
    ctx.free()

    numbers = dict(_numbers(cell, judged), window_nonfinite=nonfinite)
    timed = steps - traced
    calls = np.diff(ends)
    third = max(1, len(calls) // 3)
    print(f"[window] {timed} steps in {t1 - t0:.6f} s ({chunk} a call; {traced} traced "
          f"before it; {gen2} full garbage collections in it); {nonfinite} non-finite losses; "
          f"seconds a call: median {np.median(calls):.6f}, first third {calls[:third].mean():.6f},"
          f" last third {calls[-third:].mean():.6f}", file=ctx.err, flush=True)
    return {"attempted": steps, "failed": nonfinite,
            "end_to_end": {"train_steps_per_s": timed / (t1 - t0)},
            "numbers": numbers, "judged": judged, "trace": rec,
            "layer": {"traced_units": [1] * traced, "untraced_units": [1] * timed,
                      "untraced_s": t1 - t0}}
