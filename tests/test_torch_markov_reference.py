"""The port's temporal GP on the state-space path
(``markov_logpdf(fx, y, parallel=True)``), driven as the benchmark's
``markov_gp`` family drives it, against the plain reference that decides
``markov1m.train``'s ``correct`` (``gpbench/reference/markov_gp.py``), and
the reference against a dense Cholesky.

- The reference against log N(y; 0, K + noise·I) by a dense float64
  Cholesky at N = 600 over U(0, 50) with repeated timepoints: the value and
  the gradient in σ², ℓ and the noise. Two exact methods in float64, whose
  gaps are rounding: 2e-16 on the value and 1e-14 on a gradient entry; the
  tolerances leave 1e3 of room.
- The program against the reference at N = 5 000 over U(0, 5) (the cell's
  spacing, 1e-3), 100 of the steps repeated timepoints, ``_PAR_CHUNK`` =
  512 so that the program's scan runs ten chunks and nine carries. In
  float64 both filter the same model in another order of sums: 2e-16 on
  the value and on the worst leaf of the gradient by raw leaf (the gap of
  norms over the larger of the leaf's and the median leaf's), so 1e-12 and
  1e-11 leave ≥ 1e4 of room. In float32, the cell's precision: 1.2e-7 and
  8.7e-8, against 1e-6 and 1e-5.
- Three ``fit`` steps through the family's ``TrainProblem`` in float32
  against the reference's ``train_steps``: each loss 1.1e-7 and the first
  gradient 6.6e-8 (tolerances as above), the change over three Adam steps
  2.1e-6 against 1e-5.
- TF32 in the reference's place (``Prec("tf32")``: float32, each product
  of the 2 × 2 arrays with its operands rounded to TF32) reads 9.3e-5 on
  the value and 2.4e-3 on the gradient, both ≥ 90× their float32
  tolerances, so the tolerances would see a program that took its products
  in TF32.
"""

import math

import pytest
import torch
import torch_threads  # noqa: F401

import abstractgps_tpu_torch.params as P
from abstractgps_tpu_torch.models import markov
from abstractgps_tpu_torch.ops import distance
from gpbench import compare
from gpbench.families import markov_gp as family
from gpbench.generators import train
from gpbench.numerics import TF32
from gpbench.reference import markov_gp as ref

CFG = {"name": "markov-small", "family": "markov_gp", "kernel": "matern32", "n": 5000, "d": 1,
       "dtype": "float32", "theta0": {"s2": 1.0, "ell": 0.5, "noise": 0.1},
       "data": {"t_max": 5.0, "periods": [1.0, 4.6416, 21.544, 100.0],
                "amplitudes": [0.4, 0.6, 0.8, 1.0], "noise_std": 0.3}}
TRAFFIC = {"generator": "train", "steps_per_call": 4, "learning_rate": 0.01, "first_steps": 3}

DENSE_REL = 1e-12        # the reference against the dense Cholesky, value and gradient
TOL = {torch.float64: {"value": 1e-12, "grad": 1e-11},
       torch.float32: {"value": 1e-6, "grad": 1e-5}}
DELTA_REL = 1e-5         # the change over three Adam steps in float32


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))
    monkeypatch.setattr(markov, "_PAR_CHUNK", 512)


def _dense_loglik(t, y, s2, ell, noise):
    r = math.sqrt(3.0) * (t[:, None] - t[None, :]).abs() / ell
    K = s2 * (1.0 + r) * torch.exp(-r) + noise * torch.eye(t.shape[0], dtype=t.dtype)
    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    return -0.5 * (y @ alpha) - torch.log(torch.diagonal(L)).sum() - 0.5 * t.shape[0] * math.log(
        2.0 * math.pi)


@pytest.mark.parametrize("what", ["value", "grad"])
def test_the_reference_matches_a_dense_cholesky(what):
    g = torch.Generator().manual_seed(2147483663)
    t = torch.sort(torch.rand(600, generator=g, dtype=torch.float64) * 50.0).values
    t[101:111] = t[100]  # repeated timepoints: Δt = 0, A = I, Q = 0
    t[301] = t[300]
    y = torch.sin(t) + 0.3 * torch.randn(600, generator=g, dtype=torch.float64)
    th = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (1.3, 0.7, 0.1)]
    want, got = _dense_loglik(t, y, *th), ref.loglik(t, y, *th)
    if what == "value":
        assert abs(float((got - want).detach())) <= DENSE_REL * abs(float(want.detach()))
    else:
        gw, gg = torch.autograd.grad(want, th), torch.autograd.grad(got, th)
        for a, b in zip(gg, gw):
            assert abs(float(a - b)) <= DENSE_REL * max(abs(float(b)) for b in gw)


def _problem(dtype):
    """The family's problem on its data at N = 5000 over U(0, 5) in
    ``dtype``, every 50th step a repeated timepoint."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)  # θ0's tensors
    try:
        gen = torch.Generator().manual_seed(2147483659)
        data = family.make_data(CFG, gen)
        t = data["t"].clone()
        t[1::50] = t[0::50]
        data = {"t": t.to(dtype), "y": data["y"].to(dtype)}
        assert int((t[1:] == t[:-1]).sum()) == 100
        return family.TrainProblem(CFG, TRAFFIC, data, gen)
    finally:
        torch.set_default_dtype(prev)


def _at_start(prob):
    """(the program's loss and gradient by raw leaf at θ0, the raw leaves)."""
    names = sorted(prob.theta0)
    leaves = P.leaves(prob.theta0)
    val = prob.loss(prob.theta0)
    grads = dict(zip(names, torch.autograd.grad(val, leaves)))
    return float(val.detach()), grads, dict(zip(names, (t.detach() for t in leaves)))


def _reference(prob, raw, prec=ref.F64):
    names = sorted(raw)
    leaves = {k: prec.cast(v).requires_grad_() for k, v in raw.items()}
    val = ref.nlml(leaves, prob.data["t"], prob.data["y"], prec)
    return float(val.detach()), dict(zip(names, torch.autograd.grad(
        val, [leaves[k] for k in names])))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("what", ["value", "grad"])
def test_the_program_matches_the_reference(dtype, what):
    prob = _problem(dtype)
    val, grads, raw = _at_start(prob)
    want, want_g = _reference(prob, raw)
    if what == "value":
        assert abs(val - want) <= TOL[dtype]["value"] * abs(want)
    else:
        assert set(want_g) == {"s2", "ell", "noise"}
        assert max(compare._leaf_gaps(grads, want_g, sorted(want_g))) <= TOL[dtype]["grad"]
        for k in want_g:  # the sign as well as the size
            assert float(grads[k]) * float(want_g[k]) > 0


def test_three_fit_steps_match_the_reference():
    prob = _problem(torch.float32)
    _, prog = train._first_steps(prob, 3, TRAFFIC["learning_rate"])
    got = compare.train_numbers(prog, ref.train_steps(CFG, TRAFFIC, prob.reference_inputs(3)))
    assert got["loss_rel"] <= TOL[torch.float32]["value"]
    assert got["grad1_rel"] <= TOL[torch.float32]["grad"]
    assert got["delta_rel"] <= DELTA_REL


@pytest.mark.parametrize("what", ["value", "grad"])
def test_tf32_in_the_references_place_fails_them(what):
    prob = _problem(torch.float32)
    _, _, raw = _at_start(prob)
    want, want_g = _reference(prob, raw)
    got, got_g = _reference(prob, raw, TF32)
    if what == "value":
        assert abs(got - want) > 10 * TOL[torch.float32]["value"] * abs(want)
    else:
        assert max(compare._leaf_gaps(got_g, want_g, sorted(want_g))) > (
            10 * TOL[torch.float32]["grad"])
