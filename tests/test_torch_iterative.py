"""The port's matrix-free CG backend (``ops/matvec.py``, ``ops/pivchol.py``,
``models/iterative.py``) against the JAX package and against the dense
oracles of ``tests/test_iterative.py``.

- f64 on the library path: the same inputs, made from a seed with numpy, go
  through both packages. The probes are the JAX package's own draws,
  recorded from its call and replayed through the port's draws object
  (``JaxDraws``), so both run the same estimator: values agree to 1e-9
  relative (two f64 runs of one recurrence in another op order; the CG
  rounding differences stay at that level for these well-conditioned
  systems), gradients to 1e-8.
- f32 through the kernel paths of both packages in interpret mode at small
  sizes: the CG logpdf and its gradient with the gram rebuilt in 64-row
  panels, through ``gram_tile_plain`` and ``gram_bwd_plain`` (plain and
  transposed for each backward panel), beside ``jax.grad`` of the JAX
  package's Pallas path; tolerance 1e-5 on the value and 1e-3 of each
  leaf's largest entry on the gradient (two f32 runs of 40 CG steps, whose
  Lanczos coefficients drift apart by rounding; the run seen differs by
  ≤ 2e-4).

The interpret-mode JAX side is computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import JaxDraws, kernel_tree, record_jax_draws, small_kernel_paths

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu.models import iterative as ji
from abstractgps_tpu.ops import matvec as jm
from abstractgps_tpu.ops import pivchol as jp
from abstractgps_tpu_torch.models import iterative as ti
from abstractgps_tpu_torch.ops import distance, fused_gram
from abstractgps_tpu_torch.ops import matvec as tm
from abstractgps_tpu_torch.ops import pivchol as tp
from abstractgps_tpu_torch.utils import profiling

F64 = torch.float64


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


def _n(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, rtol=1e-9, atol=1e-10):
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=rtol, atol=atol)


def _setup(rng, n=192, d=3, noise=0.25):
    """The JAX tests' model, in both packages: (fj, fxj, ft, fxt, x, y)."""
    x = rng.uniform(size=(n, d))
    y = rng.normal(size=(n,))
    kj = 1.7 * agp.with_lengthscale(agp.Matern52Kernel(), 0.9)
    fj = agp.GP(0.4, kj)
    ft = agt.GP(0.4, agt.kernel_from_numpy(kernel_tree(kj), device="cpu"))
    return fj, fj(jnp.asarray(x), noise), ft, ft(_t(x), noise), x, y


# ---------------------------------------------------------------------------
# matvec, pivoted Cholesky, Woodbury
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("branch", ["dense", "panel"])
def test_gram_matvec_matches_jax(rng, branch):
    # 150 rows in 64-row panels: two whole panels and a ragged one padded
    fj, fxj, ft, fxt, x, _ = _setup(rng, n=150)
    max_dense_n = 8192 if branch == "dense" else 100
    V = rng.normal(size=(150, 4))
    mvj = jm.make_gram_matvec(fj.kernel, fxj.x, fxj.noise.diag(), panel=64,
                              max_dense_n=max_dense_n)
    mvt = tm.make_gram_matvec(ft.kernel, fxt.x, fxt.noise.diag(), panel=64,
                              max_dense_n=max_dense_n)
    want = np.asarray(mvj(jnp.asarray(V)))
    _close(mvt(_t(V)), want)
    _close(mvt(_t(V[:, 0])), want[:, 0])  # vector form
    _close(mvt(_t(V)), _n(fxt.cov()) @ V)


def test_gram_matvec_panel_rows_and_vector(rng):
    fj, fxj, ft, fxt, x, _ = _setup(rng, n=150)
    v = rng.normal(size=150)
    got = tm.gram_matvec(ft.kernel, fxt.x, fxt.noise.diag(), _t(v), panel=64)
    assert got.shape == (150,)
    _close(got, np.asarray(jm.gram_matvec(fj.kernel, fxj.x, fxj.noise.diag(), jnp.asarray(v),
                                          panel=64)))


@pytest.mark.parametrize("rank", [32, 120])
def test_pivoted_cholesky_matches_jax(rng, rank):
    # the same greedy pivots give the same factor; at full rank L Lᵀ = K
    fj, fxj, ft, fxt, x, _ = _setup(rng, n=120)
    Lj = np.asarray(jp.pivoted_cholesky(fj.kernel, fxj.x, rank))
    Lt = tp.pivoted_cholesky(ft.kernel, fxt.x, rank)
    assert Lt.shape == (120, rank)
    _close(Lt, Lj, rtol=1e-8, atol=1e-9)
    if rank == 120:
        _close(Lt @ Lt.T, _n(ft.kernel.gram(fxt.x)), rtol=1e-8, atol=1e-9)


def test_woodbury_matches_jax(rng):
    fj, fxj, ft, fxt, x, _ = _setup(rng, n=120)
    nd = rng.uniform(0.1, 0.3, size=120)
    Lj = jp.pivoted_cholesky(fj.kernel, fxj.x, 32)
    solve_j, logdet_j, sample_j = jp.woodbury_preconditioner(Lj, jnp.asarray(nd))
    solve_t, logdet_t, sample_t = tp.woodbury_preconditioner(_t(np.asarray(Lj)), _t(nd))
    V = rng.normal(size=(120, 3))
    _close(solve_t(_t(V)), np.asarray(solve_j(jnp.asarray(V))))
    _close(solve_t(_t(V[:, 0])), np.asarray(solve_j(jnp.asarray(V[:, 0]))))
    _close(logdet_t, float(logdet_j), rtol=1e-12)
    P = np.asarray(Lj) @ np.asarray(Lj).T + np.diag(nd)
    _close(solve_t(_t(V)), np.linalg.solve(P, V), rtol=1e-8)
    with record_jax_draws() as rec:
        Zj = np.asarray(sample_j(jax.random.PRNGKey(4), 5))
    _close(sample_t(JaxDraws(rec), 5), Zj)


# ---------------------------------------------------------------------------
# mBCG and SLQ
# ---------------------------------------------------------------------------


def _indefinite_operator(rng, n=40):
    """A symmetric operator with one negative eigenvalue, and right-hand
    sides that break down at once (the negative eigenvector), freeze after
    three steps (three positive eigenvectors), never start (zeros), and run
    the whole way (a generic vector of the positive subspace)."""
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.concatenate([[-1.0], np.linspace(0.5, 20.0, n - 1)])
    A = (Q * lam) @ Q.T
    generic = Q[:, 1:] @ rng.normal(size=n - 1)
    B = np.stack([generic, Q[:, 0], Q[:, 1:4] @ np.array([1.0, -2.0, 0.5]), np.zeros(n)], 1)
    return A, B


@pytest.mark.parametrize("precond", [False, True])
def test_mbcg_matches_jax_with_frozen_and_broken_down_columns(rng, precond):
    A, B = _indefinite_operator(rng)
    d = np.linspace(1.0, 2.0, A.shape[0])  # a diagonal preconditioner
    pj = (lambda v: v / jnp.asarray(d)[:, None]) if precond else None
    pt = (lambda v: v / _t(d)[:, None]) if precond else None
    Xj, coeffs_j = ji.mbcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(B), max_iters=30,
                           tol=1e-10, precond=pj)
    Xt, coeffs_t = ti.mbcg(lambda v: _t(A) @ v, _t(B), max_iters=30, tol=1e-10, precond=pt)
    _close(Xt, np.asarray(Xj))
    for got, want in zip(coeffs_t[:2], coeffs_j[:2]):
        _close(got, np.asarray(want))
    act = _n(coeffs_t[2])
    np.testing.assert_array_equal(act, np.asarray(coeffs_j[2]))
    assert not act[:, 1].any()  # broke down at step 0: α = β = 0
    assert not act[:, 3].any()  # a zero right-hand side never starts
    assert act[0, 2] and not act[-1, 2]  # converged and frozen
    np.testing.assert_array_equal(_n(coeffs_t[0])[:, 1], 0.0)
    np.testing.assert_array_equal(_n(Xt)[:, 3], 0.0)
    if not precond:
        # three eigenvectors: exact after three steps, frozen from the fourth
        assert act[:3, 2].all() and not act[3:, 2].any()
        _close(Xt[:, 2], np.linalg.solve(A, B[:, 2]), rtol=1e-8)


def test_slq_logdet_matches_jax_and_dense(rng):
    fj, fxj, ft, fxt, x, _ = _setup(rng, n=96)
    K = np.asarray(fxj.cov())
    Z = np.sign(rng.normal(size=(96, 64)))
    _, coeffs = ji.mbcg(lambda v: jnp.asarray(K) @ v, jnp.asarray(Z), max_iters=96, tol=1e-12)
    norms2 = jnp.sum(jnp.asarray(Z) ** 2, axis=0)
    want = float(ji.slq_logdet(*coeffs, norms2))
    got = ti.slq_logdet(*(_t(np.asarray(c), None) for c in coeffs), _t(np.asarray(norms2)))
    _close(got, want, rtol=1e-10)
    # the estimator itself: within a few percent of the dense logdet
    assert abs(float(got) - np.linalg.slogdet(K)[1]) < 0.05 * abs(np.linalg.slogdet(K)[1])


# ---------------------------------------------------------------------------
# cg_logpdf: value and gradient on the JAX package's probes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [0, 16])
@pytest.mark.parametrize("matrix_y", [False, True])
def test_cg_logpdf_matches_jax(rng, rank, matrix_y):
    fj, fxj, ft, fxt, x, y = _setup(rng, n=150)
    Y = np.stack([y, 0.5 * y], 1) if matrix_y else y
    kw = dict(num_probes=8, max_iters=60, precond_rank=rank, panel=64, max_dense_n=100)
    with record_jax_draws() as rec:
        want = np.asarray(ji.cg_logpdf(fxj, jnp.asarray(Y), jax.random.PRNGKey(3), **kw))
    got = ti.cg_logpdf(fxt, _t(Y), JaxDraws(rec), **kw)
    assert got.shape == want.shape
    _close(got, want)
    # the estimate is close to the dense logpdf (the JAX tests' 2e-2)
    exact = _n(fxt.logpdf(_t(Y)))
    assert np.all(np.abs(_n(got) - exact) < 2e-2 * np.abs(exact))


@pytest.mark.parametrize("rank", [0, 16])
def test_cg_logpdf_gradient_matches_jax_grad(rng, rank):
    # same probes ⇒ the BBMM estimator is deterministic: the port's backward
    # must reproduce jax.grad of the JAX package's custom VJP
    _, _, _, _, x, y = _setup(rng, n=150)
    kw = dict(num_probes=8, max_iters=60, precond_rank=rank, panel=64, max_dense_n=100)

    def loss_j(s2, ell, noise, yy):
        k = s2 * agp.with_lengthscale(agp.Matern52Kernel(), ell)
        return ji.cg_logpdf(agp.GP(0.4, k)(jnp.asarray(x), noise), yy,
                            jax.random.PRNGKey(5), **kw)

    with record_jax_draws() as rec:
        want = jax.grad(loss_j, argnums=(0, 1, 2, 3))(1.7, 0.9, 0.25, jnp.asarray(y))
    th = [torch.tensor(v, dtype=F64, requires_grad=True) for v in (1.7, 0.9, 0.25)]
    yt = _t(y).requires_grad_()
    k = th[0] * agt.with_lengthscale(agt.Matern52Kernel(), th[1])
    out = ti.cg_logpdf(agt.GP(0.4, k)(_t(x), th[2]), yt, JaxDraws(rec), **kw)
    got = torch.autograd.grad(out, [*th, yt])
    for g, w in zip(got, want):
        _close(g, np.asarray(w), rtol=1e-8, atol=1e-9 * np.abs(np.asarray(w)).max())


def test_cg_logpdf_input_gradient_matches_jax_grad(rng):
    # x̄ through the panel VJP (plain and transposed)
    _, _, _, _, x, y = _setup(rng, n=100)
    kw = dict(num_probes=4, max_iters=50, panel=32, max_dense_n=50)
    k_j = 1.7 * agp.with_lengthscale(agp.Matern52Kernel(), 0.9)

    def loss_j(xx):
        return ji.cg_logpdf(agp.GP(k_j)(xx, 0.25), jnp.asarray(y), jax.random.PRNGKey(2), **kw)

    with record_jax_draws() as rec:
        want = np.asarray(jax.grad(loss_j)(jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    k_t = agt.kernel_from_numpy(kernel_tree(k_j), device="cpu")
    out = ti.cg_logpdf(agt.GP(k_t)(xt, 0.25), _t(y), JaxDraws(rec), **kw)
    _close(torch.autograd.grad(out, xt)[0], want, rtol=1e-8, atol=1e-9 * np.abs(want).max())


KN, KD = 200, 3  # 200 rows in 64-row panels: the fused gram from 32² pairs
K_KW = dict(num_probes=8, max_iters=40, panel=64, max_dense_n=64, precond_rank=16)


def _kernel_path_data():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(KN, KD)).astype(np.float32)
    y = rng.normal(size=KN).astype(np.float32)
    return x, y, [np.float32(1.2), np.float32(0.7), np.float32(0.1)]


@pytest.fixture(scope="module")
def jax_kernel_path():
    x, y, vals = _kernel_path_data()

    def loss(s2, ell, noise, yy):
        k = s2 * agp.with_lengthscale(agp.Matern32Kernel(), ell)
        return ji.cg_logpdf(agp.GP(k)(jnp.asarray(x), noise), yy, jax.random.PRNGKey(5),
                            **K_KW)

    with small_kernel_paths(), record_jax_draws() as rec:
        val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
            *(jnp.float32(v) for v in vals), jnp.asarray(y))
    return float(val), [np.asarray(g) for g in grads], rec


def test_cg_logpdf_kernel_path_f32_matches_jax(jax_kernel_path, monkeypatch):
    x, y, vals = _kernel_path_data()
    want_val, want, rec = jax_kernel_path
    tiles, modes = [], []
    orig_tile, orig_bwd = fused_gram.gram_tile, fused_gram.gram_bwd
    monkeypatch.setattr(fused_gram, "gram_tile",
                        lambda *a, **k: tiles.append(a[0].shape[0]) or orig_tile(*a, **k))
    monkeypatch.setattr(fused_gram, "gram_bwd",
                        lambda *a, **k: modes.append(a[6]) or orig_bwd(*a, **k))
    with small_kernel_paths():
        th = [torch.tensor(v, requires_grad=True) for v in vals]
        yt = torch.as_tensor(y).requires_grad_()
        k = th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1])
        before = dict(profiling.LIBRARY_CALLS)
        out = ti.cg_logpdf(agt.GP(k)(torch.as_tensor(x), th[2]), yt, JaxDraws(rec), **K_KW)
        ran = profiling.LIBRARY_CALLS["cg_matvec"] - before["cg_matvec"]
        fused = profiling.LIBRARY_CALLS["cg_fused_matvec"] - before["cg_fused_matvec"]
        n_fwd = len(tiles)
        got = torch.autograd.grad(out, [*th, yt])
    panels = -(-KN // 64)
    assert out.dtype == torch.float32
    # every CG step run (the solver stops once every column froze) is one
    # fused matvec (σ²·Matérn-3/2∘ScaleTransform: its plain twin here), with
    # no gram tile; the backward builds one gram tile per panel, each panel's
    # VJP plain (its rows) and transposed (the columns)
    assert 0 < ran <= K_KW["max_iters"] and fused == ran
    assert n_fwd == 0 and len(tiles) == panels
    assert set(tiles) == {64}
    assert sorted(modes) == ["plain"] * panels + ["transpose"] * panels
    np.testing.assert_allclose(float(out.detach()), want_val, rtol=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_n(g), w, rtol=0, atol=1e-3 * np.abs(w).max())


# ---------------------------------------------------------------------------
# The CG posterior and the dispatch
# ---------------------------------------------------------------------------


def _jax_cg_tree(p):
    return {"prior": {"kernel": kernel_tree(p.prior.kernel),
                      "mean": {"type": "ConstMean", "c": np.asarray(p.prior.mean_fn.c)}},
            "x": np.asarray(p.x), "noise_diag": np.asarray(p.noise_diag),
            "alpha": np.asarray(p.alpha), "Lk": None if p.Lk is None else np.asarray(p.Lk),
            "max_iters": p.max_iters, "tol": p.tol, "panel": p.panel,
            "max_dense_n": p.max_dense_n, "precond_rank": p.precond_rank}


@pytest.mark.parametrize("rank", [0, 64])
def test_cg_posterior_matches_jax(rng, rank):
    fj, fxj, ft, fxt, x, y = _setup(rng, n=128)
    xs, zs = rng.uniform(size=(17, 3)), rng.uniform(size=(9, 3))
    inf_j = ji.CGInference(max_iters=150, tol=1e-12, precond_rank=rank)
    inf_t = agt.CGInference(max_iters=150, tol=1e-12, precond_rank=rank)
    pj = agp.posterior(inf_j, fxj, jnp.asarray(y))
    pt = agt.posterior(inf_t, fxt, _t(y))
    assert isinstance(pt, agt.CGPosteriorGP)
    _close(pt.alpha, np.asarray(pj.alpha), rtol=1e-8, atol=1e-9)
    # the JAX posterior's own state carried across predicts the same
    pc = agt.cg_posterior_from_numpy(_jax_cg_tree(pj), device="cpu")
    xsj, zsj, xst, zst = jnp.asarray(xs), jnp.asarray(zs), _t(xs), _t(zs)
    for p in (pt, pc):
        _close(p.mean(xst), np.asarray(pj.mean(xsj)), rtol=1e-8, atol=1e-9)
        _close(p.var(xst), np.asarray(pj.var(xsj)), rtol=1e-7, atol=1e-9)
        _close(p.cov(xst, zst), np.asarray(pj.cov(xsj, zsj)), rtol=1e-7, atol=1e-9)
        m1, c1 = p.mean_and_cov(xst)
        mj, cj = pj.mean_and_cov(xsj)
        _close(m1, np.asarray(mj), rtol=1e-8, atol=1e-9)
        _close(c1, np.asarray(cj), rtol=1e-7, atol=1e-9)
        m2, v2 = p.mean_and_var(xst)
        _close(m2, _n(m1), rtol=1e-12)
        _close(v2, np.diagonal(_n(c1)), rtol=1e-8, atol=1e-10)
    # and the exact posterior (tests/test_iterative.py:128-151)
    pe = agt.posterior(fxt, _t(y))
    _close(pt.mean(xst), _n(pe.mean(xst)), rtol=1e-7, atol=1e-8)
    _close(pt.var(xst), _n(pe.var(xst)), rtol=1e-6, atol=1e-8)


def _cg_pred_grad_setup(rng):
    x, y, xs = rng.uniform(size=(64, 3)), rng.normal(size=64), rng.uniform(size=(5, 3))
    # f64 at N = 64: 64 steps with tol 1e-12 converge both the JAX package's
    # unrolled scan and the port's forward and backward solves, so the
    # implicit and the unrolled gradients agree to the solves' residuals
    kw = dict(max_iters=64, tol=1e-12, precond_rank=0)
    return x, y, xs, kw


def _port_cg_posterior(x, yt, theta, kw):
    k = theta[0] * agt.with_lengthscale(agt.Matern32Kernel(), theta[1])
    return agt.posterior(agt.CGInference(**kw), agt.GP(0.3, k)(_t(x), theta[2]), yt)


def test_cg_posterior_mean_and_var_gradient_matches_jax_grad(rng):
    # ∇ of Σmean + Σvar in x*, σ², ℓ, the noise and y: the port's implicit
    # backward (one more CG solve) against jax.grad through the JAX package's
    # unrolled CG, both at f64; measured ≤ 5e-10 relative, so 1e-8 holds the
    # gap that the CG tolerance 1e-12 leaves with room
    x, y, xs, kw = _cg_pred_grad_setup(rng)

    def loss_j(xs_, s2, ell, noise, yy):
        k = s2 * agp.with_lengthscale(agp.Matern32Kernel(), ell)
        p = agp.posterior(ji.CGInference(**kw), agp.GP(0.3, k)(jnp.asarray(x), noise), yy)
        m, v = p.mean_and_var(xs_)
        return jnp.sum(m) + jnp.sum(v)

    want = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(jnp.asarray(xs), 1.3, 0.8, 0.25,
                                                     jnp.asarray(y))
    th = [torch.tensor(v, dtype=F64, requires_grad=True) for v in (1.3, 0.8, 0.25)]
    xst, yt = _t(xs).requires_grad_(), _t(y).requires_grad_()
    m, v = _port_cg_posterior(x, yt, th, kw).mean_and_var(xst)
    got = torch.autograd.grad(m.sum() + v.sum(), [xst, *th, yt])
    for g, w in zip(got, want):
        w = np.asarray(w)
        _close(g, w, rtol=0, atol=1e-8 * np.abs(w).max())


def test_cg_posterior_mean_input_gradient_runs_no_cg(rng, monkeypatch):
    # mean = m(x*) + K(x*, X)α: its ∇x* is the gram's own backward; once the
    # posterior is built, no CG solve may run
    x, y, xs, kw = _cg_pred_grad_setup(rng)
    k_j = 1.3 * agp.with_lengthscale(agp.Matern32Kernel(), 0.8)
    pj = agp.posterior(ji.CGInference(**kw), agp.GP(0.3, k_j)(jnp.asarray(x), 0.25),
                       jnp.asarray(y))
    want = np.asarray(jax.grad(lambda a: jnp.sum(pj.mean(a)))(jnp.asarray(xs)))
    th = [torch.tensor(v, dtype=F64) for v in (1.3, 0.8, 0.25)]
    p = _port_cg_posterior(x, _t(y), th, kw)

    def no_cg(*a, **k):
        raise AssertionError("mean ran a CG solve")

    monkeypatch.setattr(ti, "mbcg", no_cg)
    xst = _t(xs).requires_grad_()
    (got,) = torch.autograd.grad(p.mean(xst).sum(), xst)
    _close(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_approx_log_evidence_dispatch_and_probe_seed(rng):
    fj, fxj, ft, fxt, x, y = _setup(rng, n=128)
    inf = agt.CGInference(max_iters=150, precond_rank=32, probe_seed=7)
    ev = agt.approx_log_evidence(inf, fxt, _t(y))
    same = ti.cg_logpdf(fxt, _t(y), 7, max_iters=150, precond_rank=32)
    assert float(ev) == float(same)
    other = agt.approx_log_evidence(agt.CGInference(max_iters=150, precond_rank=32,
                                                    probe_seed=8), fxt, _t(y))
    assert float(other) != float(ev)
    exact = float(fxt.logpdf(_t(y)))
    assert abs(float(ev) - exact) / abs(exact) < 3e-2


def test_cg_rejects_dense_noise_and_non_gp_prior(rng):
    _, _, ft, fxt, x, y = _setup(rng, n=32)
    S = torch.eye(32, dtype=F64) * 0.3 + 0.01
    with pytest.raises(NotImplementedError):
        ti.cg_logpdf(ft(fxt.x, agt.DenseNoise(S)), _t(y))
    with pytest.raises(NotImplementedError):
        agt.CGInference().posterior(ft(fxt.x, agt.DenseNoise(S)), _t(y))
    p = agt.posterior(fxt, _t(y))  # a PosteriorGP prior, not a kernel GP
    with pytest.raises(NotImplementedError):
        ti.cg_logpdf(p(fxt.x, 0.1), _t(y))


def _fault(name, monkeypatch):
    """Put one fault into the CG posterior's backward (``_CGSolve``)."""
    bwd, solve = ti._CGSolve.backward, ti._cg_solve
    if name == "gram cotangent sign":
        vjp = ti._contract_gram_vjp
        monkeypatch.setattr(ti, "_contract_gram_vjp",
                            lambda k, x, p, L, R, **kw: vjp(k, x, p, -L, R, **kw))
        return
    edit = {"B̄ sign": lambda g: g[:3] + (-g[3],) + g[4:],
            "B̄ 100×": lambda g: g[:3] + (100.0 * g[3],) + g[4:],
            "noise sign": lambda g: g[:2] + (-g[2],) + g[3:],
            "noise term missing": lambda g: g[:2] + (torch.zeros_like(g[2]),) + g[3:]}

    def faulty(ctx, Xbar):
        if name == "wrong operator":  # the backward's solve against A + noise·I
            monkeypatch.setattr(ti, "_cg_solve",
                                lambda k, x, nd, B, Lk, o: solve(k, x, 2.0 * nd, B, Lk, o))
            try:
                return bwd(ctx, Xbar)
            finally:
                monkeypatch.setattr(ti, "_cg_solve", solve)
        return edit[name](bwd(ctx, Xbar))

    monkeypatch.setattr(ti._CGSolve, "backward", staticmethod(faulty))


@pytest.mark.parametrize("fault", [None, "gram cotangent sign", "B̄ sign", "B̄ 100×", "noise sign",
                                   "noise term missing", "wrong operator"])
def test_chip_smoke_cg_grad_check_fails_a_faulted_backward(fault, monkeypatch):
    # chip_smoke.py's [cg grad] verdict at f64, N = 256: the port's backward
    # passes; each fault of the backward fails it (the f64 CG error is ~1e-5
    # of each limit, a fault's error ≥ 10 limits)
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    rng = np.random.default_rng(0)
    x, y, xs = (_t(a) for a in (rng.uniform(size=(256, 8)), rng.normal(size=256),
                                rng.uniform(size=(16, 8))))
    if fault:
        _fault(fault, monkeypatch)
    th = [torch.tensor(v, dtype=F64, requires_grad=True) for v in (1.0, 1.0, 0.1)]
    xst = xs.clone().requires_grad_()
    calls = []
    mbcg = ti.mbcg

    def spy(mv, B, **kw):
        out = mbcg(mv, B, **kw)
        calls.append((out[0], B))
        return out

    monkeypatch.setattr(ti, "mbcg", spy)
    fx = agt.GP(th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1]))(x, th[2])
    m, v = agt.posterior(agt.CGInference(), fx, y).mean_and_var(xst)
    got = torch.autograd.grad(m.sum() + v.sum(), [xst, *th])
    solves = {"alpha": calls[0], "W": calls[1]}
    for X, B in calls[2:]:
        solves["alpha backward" if B.shape[1] == 1 else "W backward"] = (X, B)
    ref = cs.cg_grad_oracle_f64(x, y, xs, solves, noise=0.1)
    ok, ratios = cs.cg_grad_verdict(got[0], torch.stack(got[1:]), ref,
                                    torch.finfo(F64).eps ** 0.5)
    assert ok == (fault is None), ratios
