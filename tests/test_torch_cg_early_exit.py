"""``models.iterative.mbcg`` stops once every column has frozen, and gives
the fixed-trip loop's outputs bit for bit.

Once no column is active a CG step records α = β = 0 (inactive) and leaves
X as it was, so the steps after the last active one are no-ops; ``mbcg``
skips them and pads the coefficient stacks with those rows. Each case here
runs ``mbcg`` beside the loop it replaced (``cg_fixed_trip``) on the same
operator and compares X, α, β and the active masks in shape, dtype and
every bit; then ``cg_logpdf`` (value and gradients) and the CG posterior
with ``mbcg`` swapped for that loop. The counters: ``cg_matvec`` counts the
steps run, ``cg_skipped_matvec`` the rest of ``max_iters``, and on the CPU,
which reads the masks at once, no step runs with every column frozen.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401
from cg_fixed_trip import assert_bitwise, fixed_trip_mbcg

import abstractgps_tpu_torch as agt
from abstractgps_tpu_torch.models import iterative as ti
from abstractgps_tpu_torch.ops import distance
from abstractgps_tpu_torch.ops.pivchol import woodbury_preconditioner
from abstractgps_tpu_torch.utils import profiling

N = 64


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


def _operator(dtype, precond):
    """A = Q diag(λ) Qᵀ with λ in [1, 10], and B whose columns freeze at
    different steps: a combination of 3 eigenvectors (exact after 3 steps
    without the preconditioner), one of 12, two generic, and a zero column.
    The preconditioner, where asked for, is a Woodbury P = L Lᵀ + D."""
    gen = np.random.default_rng(5)
    Q, _ = np.linalg.qr(gen.normal(size=(N, N)))
    A = (Q * np.linspace(1.0, 10.0, N)) @ Q.T
    B = np.stack([Q[:, :3] @ gen.normal(size=3), Q[:, 3:15] @ gen.normal(size=12),
                  gen.normal(size=N), gen.normal(size=N), np.zeros(N)], 1)
    A, B = (torch.as_tensor(a, dtype=dtype) for a in (A, B))
    psolve = None
    if precond:
        Lk = torch.as_tensor(0.3 * gen.normal(size=(N, 4)), dtype=dtype)
        d = torch.as_tensor(np.linspace(1.0, 2.0, N), dtype=dtype)
        psolve = woodbury_preconditioner(Lk, d)[0]
    return (lambda V: A @ V), B, psolve


def _counted(fn):
    before = dict(profiling.LIBRARY_CALLS)
    out = fn()
    return out, {k: v - before[k] for k, v in profiling.LIBRARY_CALLS.items()}


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "woodbury"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_mbcg_stops_early_and_matches_the_fixed_trip_loop_bitwise(dtype, precond):
    mv, B, psolve = _operator(dtype, precond)
    iters = 120
    got, calls = _counted(lambda: ti.mbcg(mv, B, max_iters=iters, precond=psolve))
    want = fixed_trip_mbcg(mv, B, max_iters=iters, precond=psolve)
    assert_bitwise(got, want)
    act = got[1][2]
    # columns freeze at different steps; the zero column never starts
    frozen_at = [int(act[:, j].sum()) for j in range(4)]
    assert len(set(frozen_at)) >= 2, frozen_at
    assert not act[:, 4].any() and not got[0][:, 4].any()
    # the loop ran exactly the steps in which some column was active
    ran = int(act.any(dim=1).sum())
    assert calls["cg_matvec"] == ran == max(frozen_at) < iters
    assert calls["cg_skipped_matvec"] == iters - ran
    if not precond:
        assert frozen_at[0] == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_mbcg_of_an_all_zero_block_runs_no_matvec(dtype):
    def never(V):
        raise AssertionError("a matvec with every column frozen from the start")

    B = torch.zeros((N, 3), dtype=dtype)
    got, calls = _counted(lambda: ti.mbcg(never, B, max_iters=16))
    mv, _, _ = _operator(dtype, False)
    assert_bitwise(got, fixed_trip_mbcg(mv, B, max_iters=16))
    assert calls["cg_matvec"] == 0 and calls["cg_skipped_matvec"] == 16


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "woodbury"])
def test_mbcg_that_cannot_converge_runs_every_step(precond):
    # 10 steps cannot solve a generic right-hand side of a 64-point operator
    # with 64 distinct eigenvalues: the cap is the trip count
    mv, B, psolve = _operator(torch.float64, precond)
    B = B[:, 2:4]
    got, calls = _counted(lambda: ti.mbcg(mv, B, max_iters=10, tol=1e-30, precond=psolve))
    assert_bitwise(got, fixed_trip_mbcg(mv, B, max_iters=10, tol=1e-30, precond=psolve))
    assert got[1][2].all()
    assert calls["cg_matvec"] == 10 and calls["cg_skipped_matvec"] == 0


def test_mbcg_counters_add_up_to_the_cap_and_the_cpu_runs_no_frozen_step():
    mv, B, psolve = _operator(torch.float32, True)
    with profiling.recording():
        _, calls = _counted(lambda: ti.mbcg(mv, B, max_iters=120, precond=psolve))
    assert calls["cg_matvec"] + calls["cg_skipped_matvec"] == 120
    assert calls["cg_skipped_matvec"] > 0
    assert calls["cg_converged_matvec"] == 0
    _, off = _counted(lambda: ti.mbcg(mv, B, max_iters=120, precond=psolve))
    assert off["cg_converged_matvec"] == 0  # read only while recording
    assert off["cg_matvec"] == calls["cg_matvec"]


def _problem(n=150, seed=7):
    gen = np.random.default_rng(seed)
    x = torch.as_tensor(gen.uniform(size=(n, 3)))
    y = torch.as_tensor(gen.normal(size=n))
    return x, y


def _fx(th, x):
    k = th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1])
    return agt.GP(k)(x, th[2])


def _leaves(x, y):
    th = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (1.3, 0.6, 0.2)]
    return th, x.clone().requires_grad_(), y.clone().requires_grad_()


@pytest.mark.parametrize("rank", [0, 16])
def test_cg_logpdf_value_and_gradients_match_the_fixed_trip_loop_bitwise(rank, monkeypatch):
    # 150 points in 64-row panels (past max_dense_n): the panel matvec
    x0, y0 = _problem()
    kw = dict(num_probes=8, max_iters=150, precond_rank=rank, panel=64, max_dense_n=100)

    def value_and_grads():
        th, x, y = _leaves(x0, y0)
        lp = ti.cg_logpdf(_fx(th, x), y, 3, **kw)
        return [lp.detach(), *torch.autograd.grad(lp, [*th, x, y])]

    got, calls = _counted(value_and_grads)
    assert calls["cg_skipped_matvec"] > 0 and calls["cg_matvec"] < kw["max_iters"]
    monkeypatch.setattr(ti, "mbcg", fixed_trip_mbcg)
    want = value_and_grads()
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b), (a, b)


def test_cg_posterior_mean_and_var_match_the_fixed_trip_loop_bitwise(monkeypatch):
    # CGInference()'s defaults (256 steps, rank-64 preconditioner, the dense
    # matvec at this size); the mean, the variance and their gradients
    # through _CGSolve's forward and backward solves
    x0, y0 = _problem(n=200, seed=9)
    xs0 = torch.as_tensor(np.random.default_rng(2).uniform(size=(7, 3)))

    def answers():
        th, x, y = _leaves(x0, y0)
        xs = xs0.clone().requires_grad_()
        m, v = agt.posterior(agt.CGInference(), _fx(th, x), y).mean_and_var(xs)
        return [m.detach(), v.detach(),
                *torch.autograd.grad(m.sum() + v.sum(), [*th, x, y, xs])]

    got, calls = _counted(answers)
    assert calls["cg_skipped_matvec"] > 0
    monkeypatch.setattr(ti, "mbcg", fixed_trip_mbcg)
    want = answers()
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b), (a, b)
