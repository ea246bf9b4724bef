"""The numbers that decide ``correct``, computed from what the timed path
produced and what the plain reference computed from the same inputs.

Training (three steps that the window's own call made in set-up, and the
reference followed): each step's loss relative to the reference's; the
norm of the first gradient as the optimizer got it, and the norm of the
parameters' change over the three steps, each by the worst leaf: the gap
between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and are left out of the change. Where single
entries of a leaf have a gradient nought to rounding, Adam's first step
moves them by round-off too and the later steps carry that on, so the
first step's loss (``loss1_rel``) and the median leaf's change
(``delta_median_rel``) are given beside them; a cell's limits say which it
holds. Then the window's
last call, from the point the program had reached: the gap of the loss the
call recorded first and of the gradient the optimizer got at its first
step from the reference's at that point, each over the reference's loss or
leaf norm at the start of training (``point_numbers``).

Prediction (a sample of the window's queries, drawn from the seed, with
the largest): the widest gap of a mean from the reference's, in units of
the prior's standard deviation, and of a variance, in units of the prior
variance.
"""

from __future__ import annotations

import statistics

import torch

ROUND_OFF_GRAD = 1e-3  # of the median leaf's gradient norm


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(torch.as_tensor(t).double().reshape(-1)))


def _leaf_gaps(got: dict, want: dict, names) -> list:
    ref = {k: _norm(want[k]) for k in names}
    med = statistics.median(ref.values())
    return [abs(_norm(got[k]) - ref[k]) / max(ref[k], med) for k in names]


def _worst_leaf(got: dict, want: dict, names) -> float:
    return max(_leaf_gaps(got, want, names))


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [...], "grad1": {leaf: tensor},
    "delta": {leaf: tensor}}."""
    losses = [abs(float(p) - float(r)) / abs(float(r))
              for p, r in zip(prog["losses"], ref["losses"], strict=True)]
    names = sorted(ref["grad1"])
    gnorm = {k: _norm(ref["grad1"][k]) for k in names}
    med = statistics.median(gnorm.values())
    moved = [k for k in names if gnorm[k] >= ROUND_OFF_GRAD * med]
    delta = _leaf_gaps(prog["delta"], ref["delta"], moved)
    return {"loss_rel": max(losses), "loss1_rel": losses[0],
            "grad1_rel": _worst_leaf(prog["grad1"], ref["grad1"], names),
            "delta_rel": max(delta), "delta_median_rel": statistics.median(delta)}


def point_numbers(prog: dict, ref: dict, first: dict) -> dict:
    """``prog``: {"loss": float, "grad": {leaf: tensor}} at the start of a
    call; ``ref``: the reference's first step from the same point; ``first``:
    the reference's first steps from the start of training. Each gap is
    measured against the reference's scale at that start: near the optimum
    the loss can cross nought and the gradient all but vanishes, while the
    rounding of both keeps the size it had at the start."""
    names = sorted(ref["grad1"])
    g0 = {k: _norm(first["grad1"][k]) for k in names}
    med = statistics.median(g0.values())
    grad = max(abs(_norm(prog["grad"][k]) - _norm(ref["grad1"][k])) / max(g0[k], med)
               for k in names)
    loss = abs(float(prog["loss"]) - float(ref["losses"][0])) / abs(float(first["losses"][0]))
    return {"window_loss_gap": loss, "window_grad_gap": grad}


def predict_numbers(answers: list, refs: list, prior_var: float) -> dict:
    """``answers`` and ``refs``: (mean, var) per sampled query."""
    mean = var = 0.0
    for (m, v), (mr, vr) in zip(answers, refs, strict=True):
        mean = max(mean, float((m.double() - mr.double().cpu()).abs().max()))
        var = max(var, float((v.double() - vr.double().cpu()).abs().max()))
    return {"mean_err": mean / prior_var ** 0.5, "var_err": var / prior_var}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: [number, limit]}), the
    limits' order kept. A number that is not finite fails."""
    checks = {k: [numbers[k], limits[k]] for k in limits}
    ok = all(v == v and abs(v) != float("inf") and v <= lim for v, lim in checks.values())
    return ok, checks
