"""The port's CG estimate of the exact GP's log marginal likelihood
(``approx_log_evidence(CGInference(), fx, y)``) and its BBMM gradient,
driven as the benchmark's ``cg_gp`` family drives it, against the plain
reference that decides ``cg32k.train``'s ``correct``
(``gpbench/reference/cg_gp.py``), on the probe normals and pivots the
family hands over.

Float64 at N = 384, D = 3, with ``CGInference()``'s settings but the panel
path forced (``max_dense_n=0``, ``panel=64``). Both sides run the same
recurrence in float64 on the same draws, so the gaps are rounding: the
gram's squared distances from the differences in the port and from the
norms in the reference (≤ 1e-15·|x|²/d² relative on the nearest pairs),
and the sums of each CG step in another order, carried over ≤ 256 steps
of a system whose preconditioned condition number is ~1e2. They read
2.5e-15 on the value and ≤ 2e-14 on a leaf of the gradient, and nought on
the change over three Adam steps; the tolerances below leave ≥ 1e4 of
room, and sit ≥ 1e6 under what TF32 in the reference's place reads: the
solver's matvec alone 5.4e-4 on the value and 2e-3 to 1e-2 on a leaf, the
benchmark's whole control 2.1e-3 and 6e-3 to 4e-2.
"""

import math

import pytest
import torch
import torch_threads  # noqa: F401

import abstractgps_tpu_torch.params as P
from abstractgps_tpu_torch.ops import distance
from gpbench import compare
from gpbench.families import cg_gp as family
from gpbench.generators import train
from gpbench.numerics import TF32, to_tf32
from gpbench.reference import cg_gp as ref

CFG = {"name": "cg-f64-small", "family": "cg_gp", "kernel": "matern32", "n": 384, "d": 3,
       "dtype": "float64",
       "cg": {"num_probes": 32, "max_iters": 256, "tol": None, "panel": 64, "max_dense_n": 0,
              "precond_rank": 64, "probe_seed": 0},
       "theta0": {"s2": 1.0, "ell": 1.0, "noise": 0.1}}
TRAFFIC = {"generator": "train", "steps_per_call": 2, "learning_rate": 0.01, "first_steps": 3}

LOSS_REL = 1e-10   # the value, relative
GRAD_REL = 1e-9    # each leaf of the gradient, relative to the larger of its norm and the median's
DELTA_REL = 1e-8   # each leaf's change over three Adam steps, as the gradient's


@pytest.fixture
def problem(monkeypatch):
    """The family's problem on float64 data: x ~ U(0, 1)³,
    y = Σ e^{−k/2} sin(2π x_k) + 0.3·ε, θ0 = (1, 1, 0.1)."""
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)  # θ0's tensors
    try:
        gen = torch.Generator().manual_seed(2147483659)
        x = torch.rand((CFG["n"], CFG["d"]), generator=gen)
        f = torch.sin(2.0 * math.pi * x) @ torch.exp(-torch.arange(CFG["d"]) / 2.0)
        y = f + 0.3 * torch.randn(CFG["n"], generator=gen)
        yield family.TrainProblem(CFG, TRAFFIC, {"x": x, "y": y}, gen)
    finally:
        torch.set_default_dtype(prev)


def _at_start(prob):
    """(the port's loss and gradient by raw leaf at θ0, the reference's
    inputs there)."""
    names = sorted(prob.theta0)
    leaves = P.leaves(prob.theta0)
    val = prob.loss(prob.theta0)
    grads = dict(zip(names, torch.autograd.grad(val, leaves)))
    raw = dict(zip(names, (t.detach() for t in leaves)))
    return float(val.detach()), grads, prob.point_inputs(raw)


def _reference(inputs, prec=ref.F64):
    return ref.estimate(CFG, inputs["raw"], inputs["x"], inputs["y"], inputs["normals"],
                        inputs["pivots"][0], prec)


def _leaf_gaps(got, want):
    return compare._leaf_gaps(got, want, sorted(want))


def test_the_cg_logpdf_matches_the_reference(problem):
    val, _, inputs = _at_start(problem)
    want, _ = _reference(inputs)
    assert abs(val - float(want)) <= LOSS_REL * abs(float(want))


def test_its_gradient_in_s2_ell_and_the_noise_matches_the_reference(problem):
    _, grads, inputs = _at_start(problem)
    _, want = _reference(inputs)
    assert set(want) == {"s2", "ell", "noise"}
    assert max(_leaf_gaps(grads, want)) <= GRAD_REL
    for k in want:  # the sign as well as the size
        assert float(grads[k]) * float(want[k]) > 0


def test_three_fit_steps_match_the_reference(problem):
    _, prog = train._first_steps(problem, 3, TRAFFIC["learning_rate"])
    inputs = problem.reference_inputs(3)
    assert len(inputs["pivots"]) == 3
    got = compare.train_numbers(prog, ref.train_steps(CFG, TRAFFIC, inputs))
    assert got["loss_rel"] <= LOSS_REL
    assert got["grad1_rel"] <= GRAD_REL
    assert got["delta_rel"] <= DELTA_REL


@pytest.mark.parametrize("where", ["matvec", "control"])
def test_tf32_in_the_references_place_fails_them(problem, monkeypatch, where):
    # "matvec": each solver step's product with the gram rounded to TF32,
    # the rest in float64; "control": the benchmark's control, the whole
    # reference in float32 with every ``Prec.mm`` product in TF32
    val, grads, inputs = _at_start(problem)
    if where == "matvec":
        monkeypatch.setattr(ref, "dense_matvec", lambda A, V, prec: (
            to_tf32(A.float()) @ to_tf32(V.float())).double())
        got, got_g = _reference(inputs)
    else:
        got, got_g = _reference(inputs, TF32)
    assert abs(float(got) - val) > 100 * LOSS_REL * abs(val)
    assert max(_leaf_gaps(got_g, grads)) > 100 * GRAD_REL
