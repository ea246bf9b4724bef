"""The port's training path — gradients of the logpdf and of the posterior
prediction, and the two backward kernels — against the JAX package.

- The backward kernels' plain versions (``fused_gram.gram_bwd_plain``,
  ``fused_gram.logpdf_contraction_plain``) against the Pallas kernels
  (``pallas_gram._bwd_pass``, ``pallas_gram.logpdf_contraction``) in
  interpret mode, with 64-wide tiles so several tiles accumulate; bound
  2e-4·scale + 1e-5, as tests/test_pallas_kernels.py:576 holds the Pallas
  sweep against XLA.
- The backward rules of ``blocked_chol`` (logpdf core, Cholesky, the wide
  solves) against ``jax.grad`` of their JAX counterparts, both in interpret
  mode at small sizes: rtol 2e-3 / atol 2e-4 at f32, as
  tests/test_pallas_kernels.py:263 holds the fused logpdf against the dense
  one.
- Caller-supplied hyperparameter tensors reach autograd: at f64 on the
  dense path to 1e-9 relative against ``jax.grad``.

JAX sides that take seconds in interpret mode are computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import kernel_tree, small_kernel_paths, spd

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu.ops import pallas_chol, pallas_gram
from abstractgps_tpu_torch.ops import blocked_chol, distance, fused_gram

F32_GRAD = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


@pytest.fixture
def small_tiles(monkeypatch):
    with small_kernel_paths() as mp:
        mp.setattr(pallas_gram, "_TILE_N", 64)
        mp.setattr(pallas_gram, "_TILE_M", 64)
        yield mp


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _n(t):
    return t.detach().cpu().numpy()


def _close_scaled(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() + 1e-6
    assert err < 2e-4 * scale + 1e-5, (what, err, scale)


# the four parameterised/base families of the JAX backward-kernel test
BWD_FAMILIES = [
    (4, lambda: agp.RationalQuadraticKernel(alpha=jnp.float32(1.7)), "alpha"),
    (0, lambda: agp.SqExponentialKernel(), None),
    (2, lambda: agp.Matern32Kernel(), None),
    (5, lambda: agp.GammaExponentialKernel(gamma=jnp.float32(1.3)), "gamma"),
]
BWD_IDS = ["rq", "se", "matern32", "gammaexp"]


@pytest.mark.parametrize("family,make,leaf", BWD_FAMILIES, ids=BWD_IDS)
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "cross"])
def test_gram_bwd_plain_matches_pallas(rng, small_tiles, family, make, leaf, sym):
    n, m, d = 150, (150 if sym else 100), 3
    x = rng.uniform(size=(n, d)).astype(np.float32)
    z = x if sym else rng.uniform(size=(m, d)).astype(np.float32)
    C = rng.normal(size=(n, m)).astype(np.float32)
    kj = make()
    kt = agt.kernel_from_numpy(kernel_tree(kj), dtype=torch.float32)
    assert kt.FAMILY == family
    params = kt._map_params()
    xj, zj, Cj = jnp.asarray(x), jnp.asarray(z), jnp.asarray(C)
    if sym:
        xb_j, kb_j = pallas_gram._bwd_pass(True, kj, xj, xj, Cj, False, True, single_sym=True)
        xb_t, pb_t = fused_gram.gram_bwd(_t(x), _t(x), _t(C), family, params, True, "sym")
    else:
        xb_j, kb_j = pallas_gram._bwd_pass(False, kj, xj, zj, Cj, False, True)
        xb_t, pb_t = fused_gram.gram_bwd(_t(x), _t(z), _t(C), family, params, False, "plain")
        zb_j = pallas_gram._bwd_pass(False, kj, zj, xj, Cj, True, False)
        zb_t, _ = fused_gram.gram_bwd(_t(z), _t(x), _t(C), family, params, False, "transpose")
        _close_scaled(_n(zb_t), zb_j, "zbar")
    _close_scaled(_n(xb_t), xb_j, "xbar")
    if leaf is not None:
        _close_scaled(float(pb_t), float(getattr(kb_j, leaf)), leaf)
    else:
        assert float(pb_t) == 0.0


@pytest.mark.parametrize("family,make,leaf", BWD_FAMILIES, ids=BWD_IDS)
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "cross"])
def test_fused_gram_vjp_matches_pallas(rng, small_tiles, family, make, leaf, sym):
    # the autograd Function around the gram kernel: x, z and hyperparameter
    # cotangents of ⟨fused gram, C⟩ against jax.grad of the Pallas _fused
    n, m, d = 40, (40 if sym else 28), 3
    x = rng.uniform(size=(n, d)).astype(np.float32)
    z = rng.uniform(size=(m, d)).astype(np.float32)
    C = rng.normal(size=(n, m)).astype(np.float32)
    small_tiles.setattr(fused_gram, "_MIN_SIZE", 16)
    kj = make()

    def fused_j(k_, x_, z_):
        return jnp.vdot(pallas_gram._fused(sym, k_, x_, x_ if sym else z_), jnp.asarray(C))

    gj = jax.grad(fused_j, argnums=(0, 1, 2))(kj, jnp.asarray(x), jnp.asarray(z))
    kt = agt.kernel_from_numpy(kernel_tree(kj), dtype=torch.float32)
    xt = _t(x).requires_grad_()
    zt = xt if sym else _t(z).requires_grad_()
    K = kt.gram(xt) if sym else kt.cross(xt, zt)
    params = kt._map_params()
    out = torch.sum(K * _t(C))
    grads = torch.autograd.grad(out, [xt] + ([] if sym else [zt]) + list(params))
    _close_scaled(_n(grads[0]), gj[1], "x")
    if not sym:
        _close_scaled(_n(grads[1]), gj[2], "z")
    if leaf is not None:
        _close_scaled(float(grads[-1]), float(getattr(gj[0], leaf)), leaf)


@pytest.mark.parametrize("family,make,leaf", BWD_FAMILIES, ids=BWD_IDS)
def test_logpdf_contraction_plain_matches_pallas(rng, small_tiles, family, make, leaf):
    _contraction_against_pallas(rng, family, make, leaf, np.asarray([0.7, -1.3], np.float32))


@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("family,make,leaf", BWD_FAMILIES, ids=BWD_IDS)
def test_logpdf_contraction_plain_matches_pallas_rank_q(rng, small_tiles, family, make, leaf,
                                                        q):
    # δ of shape (n, q): the main path's q = 1, and a general rank
    g = np.asarray([0.7, -1.3, 0.4], np.float32)[:q]
    _contraction_against_pallas(rng, family, make, leaf, g)


def _contraction_against_pallas(rng, family, make, leaf, g):
    n, d, q = 150, 3, g.shape[0]
    xp = rng.uniform(size=(n, d)).astype(np.float32)
    K = spd(rng, n)
    T = np.tril(np.linalg.inv(K)).astype(np.float32)
    # the upper triangle is never read: fill it with garbage on the port side
    T_dirty = T + np.triu(rng.normal(size=(n, n)) * 1e3, 1).astype(np.float32)
    alpha = rng.normal(size=(n, q)).astype(np.float32)
    ag = alpha * g[None, :]
    s2, gsum = np.float32(1.3), np.float32(g.sum())
    kj = make()
    s2bar_j, kb_j, xb_j = pallas_gram.logpdf_contraction(
        kj, jnp.asarray(xp), jnp.float32(s2), jnp.asarray(ag), jnp.asarray(alpha),
        jnp.float32(gsum), jnp.asarray(T))
    kt = agt.kernel_from_numpy(kernel_tree(kj), dtype=torch.float32)
    s2bar, pbar, xb = fused_gram.logpdf_contraction(
        _t(xp), torch.tensor(s2), _t(ag), _t(alpha), torch.tensor(gsum), _t(T_dirty),
        family, kt._map_params())
    _close_scaled(_n(xb), xb_j, "xbar")
    _close_scaled(float(s2bar), float(s2bar_j), "s2bar")
    if leaf is not None:
        _close_scaled(float(pbar), float(getattr(kb_j, leaf)), leaf)


def test_logpdf_contraction_plain_ignores_the_upper_triangle(rng):
    # T is a view of a padded tril(K⁻¹) whose strict upper triangle may hold
    # anything: NaN there gives the same result, to the bit
    n, d, q = 90, 3, 2
    xp = torch.as_tensor(rng.uniform(size=(n, d)), dtype=torch.float32)
    T = torch.tril(torch.as_tensor(np.linalg.inv(spd(rng, n)), dtype=torch.float32))
    T_nan = T + torch.triu(torch.full((n, n), float("nan")), 1)
    a = torch.as_tensor(rng.normal(size=(n, q)), dtype=torch.float32)
    g = torch.tensor([0.7, -1.3])
    args = (xp, torch.tensor(1.3), a * g, a, g.sum())
    params = (torch.tensor(1.7),)
    clean = fused_gram.logpdf_contraction(*args, T, 4, params)
    dirty = fused_gram.logpdf_contraction(*args, T_nan, 4, params)
    assert all(torch.isfinite(t).all() for t in dirty)
    assert all(torch.equal(u, v) for u, v in zip(clean, dirty))


# ---------------------------------------------------------------------------
# The logpdf core: value and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

N_CORE = 70


def _core_data():
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(N_CORE, 2)).astype(np.float32)
    y = rng.normal(size=N_CORE).astype(np.float32)
    nd = rng.uniform(0.1, 0.3, size=N_CORE).astype(np.float32)
    Y = rng.normal(size=(N_CORE, 3)).astype(np.float32)
    return x, y, nd, Y


W3 = np.asarray([0.5, -1.0, 2.0], np.float32)


def _jax_core_k(p, make=agp.SEKernel):
    return p["s2"] * agp.with_lengthscale(make(), p["ell"])


@pytest.fixture(scope="module")
def jax_core():
    """jax.value_and_grad of the JAX fused logpdf core (interpret mode) for
    a vector y and a weighted 3-column Y, and the f64 dense gradient."""
    x, y, nd, Y = _core_data()
    p = {"s2": jnp.float32(1.3), "ell": jnp.float32(0.7), "nd": jnp.asarray(nd)}
    with small_kernel_paths():
        def fused(pp, yv):
            return pallas_chol.gram_logpdf_core(_jax_core_k(pp), jnp.asarray(x), pp["nd"], yv)

        v, g = jax.value_and_grad(fused, argnums=(0, 1))(p, jnp.asarray(y))
        gm = jax.grad(lambda pp, YY: jnp.dot(jnp.asarray(W3), fused(pp, YY)),
                      argnums=(0, 1))(p, jnp.asarray(Y))
    x64, y64 = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
    p64 = {k: jnp.asarray(np.asarray(v_), jnp.float64) for k, v_ in p.items()}

    def dense64(pp):
        K = agp.kernelmatrix(_jax_core_k(pp), x64) + jnp.diag(pp["nd"])
        L = jax.lax.linalg.cholesky(K)
        z = jax.lax.linalg.triangular_solve(L, y64[:, None], left_side=True, lower=True)
        return -(jnp.sum(jnp.log(jnp.diagonal(L))) + 0.5 * jnp.sum(z * z))

    g64 = jax.grad(dense64)(p64)
    return float(v), g, gm, g64


def _port_core(delta, weights=None):
    x, _, nd, _ = _core_data()
    th = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
          for k, v in (("s2", 1.3), ("ell", 0.7))}
    th["nd"] = _t(nd).requires_grad_()
    delta = _t(delta).requires_grad_()
    k = th["s2"] * agt.with_lengthscale(agt.SEKernel(), th["ell"])
    out = blocked_chol.gram_logpdf_core(k, _t(x), th["nd"], delta)
    loss = out if weights is None else torch.dot(_t(weights), out)
    grads = torch.autograd.grad(loss, [th["s2"], th["ell"], th["nd"], delta])
    return out, dict(zip(("s2", "ell", "nd", "delta"), grads))


def test_gram_logpdf_core_value_and_grad(jax_core, monkeypatch):
    v_j, (g_j, gy_j), (gm_j, gY_j), _ = jax_core
    x, y, nd, Y = _core_data()
    calls = []
    with small_kernel_paths() as mp:
        orig = fused_gram.logpdf_contraction
        mp.setattr(fused_gram, "logpdf_contraction", lambda *a: calls.append(1) or orig(*a))
        out, g = _port_core(y)
        assert calls  # the backward went through the contraction kernel's path
        np.testing.assert_allclose(float(out.detach()), v_j, rtol=1e-5)
        for key in ("s2", "ell", "nd"):
            np.testing.assert_allclose(_n(g[key]), np.asarray(g_j[key]), **F32_GRAD)
        np.testing.assert_allclose(_n(g["delta"]), np.asarray(gy_j), **F32_GRAD)
        # the matrix-Y path: per-column densities, weighted gradient
        vals, gm = _port_core(Y, W3)
        assert vals.shape == (3,)
        for key in ("s2", "ell", "nd"):
            np.testing.assert_allclose(_n(gm[key]), np.asarray(gm_j[key]), **F32_GRAD)
        np.testing.assert_allclose(_n(gm["delta"]), np.asarray(gY_j), **F32_GRAD)


@pytest.mark.parametrize("columns", [1, 3], ids=["vector", "matrix"])
def test_logpdf_value_and_grad_f64_dense(columns):
    # the same derivatives on the dense f64 path (FiniteGP.logpdf, no
    # kernel): s², ℓ, a noise vector and y (or a weighted 3-column Y)
    # against jax.value_and_grad of the JAX package at 1e-9
    x, y, nd, Y = (a.astype(np.float64) for a in _core_data())
    yv = y if columns == 1 else Y
    w = np.ones(1) if columns == 1 else W3.astype(np.float64)

    def jax_lp(p, yy):
        fx = agp.GP(_jax_core_k(p))(jnp.asarray(x), p["nd"])
        return jnp.sum(jnp.asarray(w) * jnp.atleast_1d(fx.logpdf(yy)))

    p = {"s2": 1.3, "ell": 0.7, "nd": jnp.asarray(nd)}
    v_j, (g_j, gy_j) = jax.value_and_grad(jax_lp, argnums=(0, 1))(p, jnp.asarray(yv))
    th = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (1.3, 0.7)]
    ndt = torch.as_tensor(nd).requires_grad_()
    yt = torch.as_tensor(yv).requires_grad_()
    fx = agt.GP(th[0] * agt.with_lengthscale(agt.SEKernel(), th[1]))(torch.as_tensor(x), ndt)
    out = torch.sum(torch.as_tensor(w) * torch.atleast_1d(fx.logpdf(yt)))
    got = torch.autograd.grad(out, [*th, ndt, yt])
    np.testing.assert_allclose(float(out.detach()), float(v_j), rtol=1e-12)
    for a, b in zip(got, (g_j["s2"], g_j["ell"], g_j["nd"], gy_j)):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-9, atol=1e-12)


def test_sigma2_gradient_within_budget_of_f64(jax_core):
    # the σ² gradient carries the cancelling trace term; the JAX package pins
    # its f32 error against f64 at 5e-3 relative (test_pallas_kernels.py:219)
    *_, g64 = jax_core
    x, y, nd, _ = _core_data()
    with small_kernel_paths():
        _, g = _port_core(y)
    # the f64 reference omits the constant n·log2π/2, which has no gradient
    t = float(g64["s2"])
    assert abs(float(g["s2"]) - t) < 5e-3 * abs(t)
    for key in ("ell", "nd"):
        want = np.asarray(g64[key])
        assert np.abs(_n(g[key]) - want).max() < 2e-2 * np.abs(want).max()


def test_generic_fallback_matches_fused_contraction(jax_core):
    # a kernel the fused contraction does not take (a sum) goes through
    # autograd of ⟨C, K⟩ — the gram VJP kernel's path; the same function
    # written as a sum of halves gives the same gradients
    _, (g_j, gy_j), _, _ = jax_core
    x, y, nd, _ = _core_data()
    with small_kernel_paths():
        s2 = torch.tensor(1.3, requires_grad=True)
        ell = torch.tensor(0.7, requires_grad=True)
        half = agt.with_lengthscale(agt.SEKernel(), ell)
        k = 0.5 * s2 * half + 0.5 * s2 * half
        lp = blocked_chol.gram_logpdf_core(k, _t(x), _t(nd), _t(y))
        gs2, gell = torch.autograd.grad(lp, [s2, ell])
    np.testing.assert_allclose(float(gs2), float(g_j["s2"]), **F32_GRAD)
    np.testing.assert_allclose(float(gell), float(g_j["ell"]), **F32_GRAD)


# ---------------------------------------------------------------------------
# cholesky_gram, pallas_cholesky and the wide solves: backward rules
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_chol_grads():
    rng = np.random.default_rng(9)
    n = 80
    x = rng.uniform(size=(n, 2)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    nd = rng.uniform(0.1, 0.3, size=n).astype(np.float32)
    A = spd(rng, 96).astype(np.float32)
    w = rng.normal(size=(96, 96)).astype(np.float32)

    def terms(L, yv):
        z = jax.lax.linalg.triangular_solve(L, yv[:, None], left_side=True, lower=True)[:, 0]
        return -(jnp.sum(jnp.log(jnp.diagonal(L))) + 0.5 * jnp.dot(z, z))

    with small_kernel_paths():
        def fused(p, xx):
            k = p["s2"] * agp.with_lengthscale(agp.SEKernel(), p["ell"])
            return terms(pallas_chol.cholesky_gram(k, xx, p["nd"]), jnp.asarray(y))

        p = {"s2": jnp.float32(1.2), "ell": jnp.float32(0.6), "nd": jnp.asarray(nd)}
        g_gram = jax.grad(fused, argnums=(0, 1))(p, jnp.asarray(x))
        g_chol = jax.grad(lambda A_: jnp.vdot(pallas_chol.pallas_cholesky(A_), jnp.asarray(w)))(
            jnp.asarray(A))
    return (x, y, nd, A, w), g_gram, g_chol


def test_cholesky_gram_grad_matches_jax(jax_chol_grads):
    (x, y, nd, _, _), (g_p, g_x), _ = jax_chol_grads
    with small_kernel_paths():
        s2 = torch.tensor(1.2, requires_grad=True)
        ell = torch.tensor(0.6, requires_grad=True)
        ndt, xt = _t(nd).requires_grad_(), _t(x).requires_grad_()
        k = s2 * agt.with_lengthscale(agt.SEKernel(), ell)
        assert blocked_chol.should_use_fused_gram(xt, ndt)
        L = blocked_chol.cholesky_gram(k, xt, ndt)
        z = torch.linalg.solve_triangular(L, _t(y)[:, None], upper=False)[:, 0]
        loss = -(torch.sum(torch.log(torch.diagonal(L))) + 0.5 * torch.dot(z, z))
        g = torch.autograd.grad(loss, [s2, ell, ndt, xt])
    for got, want in zip(g, (g_p["s2"], g_p["ell"], g_p["nd"], g_x)):
        np.testing.assert_allclose(_n(got), np.asarray(want), **F32_GRAD)


def test_pallas_cholesky_grad_matches_jax(jax_chol_grads):
    (_, _, _, A, w), _, g_j = jax_chol_grads
    with small_kernel_paths():
        At = _t(A).requires_grad_()
        assert blocked_chol.should_use_pallas(At)
        (g,) = torch.autograd.grad(torch.sum(blocked_chol.pallas_cholesky(At) * _t(w)), At)
    np.testing.assert_allclose(_n(g), np.asarray(g_j), rtol=5e-4,
                               atol=5e-4 * np.abs(np.asarray(g_j)).max())


@pytest.mark.parametrize("n,m", [(96, 48), (200, 33)])  # 200: the padded path
def test_wide_solve_adjoints_match_jax(rng, small_tiles, n, m):
    L = np.linalg.cholesky(spd(rng, n)).astype(np.float32)
    B = rng.normal(size=(n, m)).astype(np.float32)
    w = rng.normal(size=(n, m)).astype(np.float32)
    Lj, Bj, wj = jnp.asarray(L), jnp.asarray(B), jnp.asarray(w)
    for port, ref in ((blocked_chol.solve_lower_wide, pallas_chol.solve_lower_wide),
                      (blocked_chol.solve_upper_wide, pallas_chol.solve_upper_wide),
                      (blocked_chol.chol_solve_wide, pallas_chol.chol_solve_wide)):
        gL_j, gB_j = jax.grad(lambda L_, B_: jnp.vdot(ref(L_, B_), wj), argnums=(0, 1))(Lj, Bj)
        Lt, Bt = _t(L).requires_grad_(), _t(B).requires_grad_()
        gL, gB = torch.autograd.grad(torch.sum(port(Lt, Bt) * _t(w)), [Lt, Bt])
        for got, want in ((gL, np.tril(np.asarray(gL_j))), (gB, np.asarray(gB_j))):
            np.testing.assert_allclose(_n(got), want, rtol=2e-3,
                                       atol=2e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# Caller-supplied hyperparameters reach autograd (dense f64 and fused f32)
# ---------------------------------------------------------------------------


def test_caller_tensors_stay_in_the_graph():
    s2 = torch.tensor(1.1, dtype=torch.float64, requires_grad=True)
    ell = torch.tensor(0.9, dtype=torch.float64, requires_grad=True)
    k = s2 * agt.with_lengthscale(agt.Matern32Kernel(), ell)
    assert k.variance is s2
    hyper = agt.kernels.base.hyperparameters(k)
    assert hyper[0] is s2 and hyper[1].grad_fn is not None  # 1/ℓ, computed from ℓ
    # numbers and tensors that do not require grad still become Parameters
    k2 = 1.1 * agt.with_lengthscale(agt.Matern32Kernel(), torch.tensor(0.9))
    assert all(isinstance(p, torch.nn.Parameter) for p in agt.kernels.base.hyperparameters(k2))
    assert len(list(k2.parameters())) == 2


def test_caller_hyperparameter_grads_match_jax_f64(rng):
    x = rng.uniform(size=(50, 2))
    y = rng.normal(size=50)

    def jax_lp(s2, ell, noise):
        k = s2 * agp.with_lengthscale(agp.Matern32Kernel(), ell)
        return agp.GP(k)(jnp.asarray(x), noise).logpdf(jnp.asarray(y))

    want = jax.grad(jax_lp, argnums=(0, 1, 2))(1.1, 0.9, 0.1)
    th = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (1.1, 0.9, 0.1)]
    k = th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1])
    lp = agt.GP(k)(torch.as_tensor(x), th[2]).logpdf(torch.as_tensor(y))
    got = torch.autograd.grad(lp, th, allow_unused=True)
    assert all(g is not None and torch.isfinite(g) for g in got)
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-9)


@pytest.fixture(scope="module")
def jax_fused_grads():
    """jax.grad of logpdf and of the prediction through the JAX fused path
    (interpret mode, f32) with respect to σ², ℓ, the noise, x and y, and
    the prediction's f64 gradient."""
    rng = np.random.default_rng(17)
    x = rng.uniform(size=(150, 2)).astype(np.float32)
    y = rng.normal(size=150).astype(np.float32)
    xs = rng.uniform(size=(40, 2)).astype(np.float32)
    with small_kernel_paths():
        def lp(s2, ell, noise, xx, yy):
            k = s2 * agp.with_lengthscale(agp.Matern32Kernel(), ell)
            return agp.GP(k)(xx, noise).logpdf(yy)

        def pred(s2, ell, noise, dtype=jnp.float32):
            k = s2 * agp.with_lengthscale(agp.Matern32Kernel(), ell)
            post = agp.posterior(agp.GP(k)(jnp.asarray(x, dtype), noise),
                                 jnp.asarray(y, dtype))
            mu, var = post.mean_and_var(jnp.asarray(xs, dtype))
            return jnp.sum(mu) + jnp.sum(var)

        th = (jnp.float32(1.1), jnp.float32(0.4), jnp.float32(0.1))
        g_lp = jax.grad(lp, argnums=(0, 1, 2, 3, 4))(*th, jnp.asarray(x), jnp.asarray(y))
        g_pred = jax.grad(pred, argnums=(0, 1, 2))(*th)
    # the f64 truth of the prediction's gradient (the dense path)
    g_pred64 = jax.grad(pred, argnums=(0, 1, 2))(1.1, 0.4, 0.1, jnp.float64)
    return (x, y, xs), g_lp, g_pred, g_pred64


def test_caller_hyperparameter_grads_match_jax_fused(jax_fused_grads):
    (x, y, _), g_j, *_ = jax_fused_grads
    with small_kernel_paths():
        th = [torch.tensor(v, requires_grad=True) for v in (1.1, 0.4, 0.1)]
        xt, yt = _t(x).requires_grad_(), _t(y).requires_grad_()
        k = th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1])
        fx = agt.GP(k)(xt, th[2])
        assert blocked_chol.should_use_fused_gram(fx.x, fx.noise.diag())
        got = torch.autograd.grad(fx.logpdf(yt), [*th, xt, yt])
    for a, b in zip(got, g_j):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=2e-3,
                                   atol=2e-4 * np.abs(np.asarray(b)).max())


def test_prediction_grads_match_jax_fused(jax_fused_grads):
    # ∇ of mean.sum() + var.sum(): cholesky_gram's backward (the symmetric
    # gram VJP), the cross gram's two passes, and the wide-solve adjoints
    (x, y, xs), _, g_j, g64 = jax_fused_grads
    calls = []
    with small_kernel_paths() as mp:
        orig = fused_gram.gram_bwd
        mp.setattr(fused_gram, "gram_bwd", lambda *a: calls.append(a[6]) or orig(*a))
        th = [torch.tensor(v, requires_grad=True) for v in (1.1, 0.4, 0.1)]
        k = th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1])
        post = agt.posterior(agt.GP(k)(_t(x), th[2]), _t(y))
        mu, var = post.mean_and_var(_t(xs))
        got = torch.autograd.grad(mu.sum() + var.sum(), th)
    assert set(calls) == {"sym", "plain", "transpose"}
    # κ(K) ≈ 1.6e3 here: each package's f32 gradient is ~κ·eps·(chain
    # length) off the f64 truth (measured: the JAX package's up to 1.7e-3
    # relative, the port's, with the pullback by substitution as the JAX
    # package's, up to 3.0e-4). The port is held at 2e-3 of the truth, and
    # to the JAX package through it: no component further from the truth
    # than twice the JAX package's own f32 gradient
    got = np.asarray([float(g) for g in got])
    want, g_j = np.asarray(g64, np.float64), np.asarray(g_j, np.float64)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert np.all(np.abs(got - want) <= 2.0 * np.abs(g_j - want)), (got, g_j, want)
