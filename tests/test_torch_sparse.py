"""The port's sparse VFE/DTC approximations (``models/sparse.py``), the
``neg_elbo`` objective and the deprecated ``dtc`` alias, against the JAX
package and against the oracles of ``tests/test_sparse.py``.

- f64 on the library path: the same inputs, made from a seed with numpy, go
  through both packages; values agree to 1e-10 relative (two f64
  evaluations of the same formulas, in another op order).
- f32 through the kernel paths of both packages in interpret mode at small
  sizes: the collapsed ELBO and its gradient with respect to σ², the ARD
  lengthscales, the noise and z, beside ``jax.grad``.

The interpret-mode JAX side is computed once per module.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import param_tree, small_kernel_paths

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu import params as JP
from abstractgps_tpu.inference.training import neg_elbo as jax_neg_elbo
from abstractgps_tpu_torch import params as P
from abstractgps_tpu_torch.ops import distance, fused_gram

JITTER = 1e-12
F64 = torch.float64


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


def _f(t):
    return float(t.detach()) if isinstance(t, torch.Tensor) else float(t)


def _n(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _setup(rng, n=30, m=10):
    x = np.sort(rng.uniform(-3, 3, n))
    z = np.linspace(-3.0, 3.0, m)
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    return x, y, z


def _both(x, y, z, noise=0.1, jitter=JITTER):
    """(f, fx, vfe, y) of the JAX package and of the port on the same data."""
    fj, ft = agp.GP(agp.SqExponentialKernel()), agt.GP(agt.SqExponentialKernel())
    jax_side = (fj, fj(jnp.asarray(x), noise), agp.VFE(fj(jnp.asarray(z), jitter)), jnp.asarray(y))
    torch_side = (ft, ft(_t(x), noise), agt.VFE(ft(_t(z), jitter)), _t(y))
    return jax_side, torch_side


def test_sparse_with_inducing_eq_data_matches_exact(rng):
    # (test/sparse_approximations.jl:20-25), and the port's sparse posterior
    # against the JAX package's
    x, y, _ = _setup(rng)
    (fj, fxj, _, yj), (f, fx, _, yt) = _both(x, y, x)
    p_sparse = agt.posterior(agt.VFE(f(_t(x), JITTER)), fx, yt)
    p_exact = agt.posterior(fx, yt)
    xt = np.linspace(-2.5, 2.5, 13)

    @jax.jit
    def jax_moments(xx, yy, xs):
        pj = agp.posterior(agp.VFE(fj(xx, JITTER)), fj(xx, 0.1), yy)
        return pj.mean(xs), pj.cov(xs), pj.var(xs)

    want = jax_moments(jnp.asarray(x), yj, jnp.asarray(xt))
    for name, w in zip(("mean", "cov", "var"), want):
        got = _n(getattr(p_sparse, name)(_t(xt)))
        np.testing.assert_allclose(got, _n(getattr(p_exact, name)(_t(xt))), atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-10, atol=1e-12)


def test_elbo_bounds_logpdf(rng):
    # ELBO ≤ logpdf; equality at inducing = data (rtol 1e-5)
    # (test/sparse_approximations.jl:86-101, src/util/TestUtils.jl:213-217)
    x, y, z = _setup(rng)
    (fj, fxj, vfe_j, yj), (f, fx, vfe, yt) = _both(x, y, z)
    lp = _f(fx.logpdf(yt))
    e_sub = agt.elbo(vfe, fx, yt)
    assert _f(e_sub) <= lp + 1e-10
    np.testing.assert_allclose(_f(e_sub), _f(agp.elbo(vfe_j, fxj, yj)), rtol=1e-10)
    e_full = agt.elbo(agt.VFE(f(_t(x), JITTER)), fx, yt)
    np.testing.assert_allclose(_f(e_full), lp, rtol=1e-5, atol=1e-5)
    assert _f(agt.approx_log_evidence(vfe, fx, yt)) == _f(e_sub)


def test_dtc_equals_logpdf_at_inducing_eq_data(rng):
    # (test/sparse_approximations.jl:93-94; atol 1e-6), and the DTC objective
    # against the JAX package's at distinct inducing points
    x, y, z = _setup(rng)
    (fj, fxj, _, yj), (f, fx, _, yt) = _both(x, y, z)
    d = agt.DTC(f(_t(x), JITTER))
    np.testing.assert_allclose(_f(agt.approx_log_evidence(d, fx, yt)), _f(fx.logpdf(yt)),
                               atol=1e-6, rtol=1e-6)
    got = agt.approx_log_evidence(agt.DTC(f(_t(z), JITTER)), fx, yt)
    want = agp.approx_log_evidence(agp.DTC(fj(jnp.asarray(z), JITTER)), fxj, yj)
    np.testing.assert_allclose(_f(got), _f(want), rtol=1e-10)


def test_dtc_alias_warns_and_equals_approx_log_evidence(rng):
    x, y, z = _setup(rng)
    _, (f, fx, _, yt) = _both(x, y, z)
    d = agt.DTC(f(_t(z), JITTER))
    with pytest.warns(DeprecationWarning, match="approx_log_evidence"):
        got = agt.dtc(d, fx, yt)
    assert _f(got) == _f(agt.approx_log_evidence(d, fx, yt))


def test_posterior_consistency(rng):
    x, y, z = _setup(rng)
    (_, fxj, vfe_j, yj), (f, fx, vfe, yt) = _both(x, y, z)
    p = agt.posterior(vfe, fx, yt)
    pj = agp.posterior(vfe_j, fxj, yj)
    xt = _t(np.linspace(-2, 2, 7))
    m, C = p.mean_and_cov(xt)
    np.testing.assert_allclose(_n(m), _n(p.mean(xt)), atol=1e-10)
    np.testing.assert_allclose(_n(C), _n(p.cov(xt)), atol=1e-10)
    m2, v = p.mean_and_var(xt)
    np.testing.assert_allclose(_n(v), np.diag(_n(C)), atol=1e-8)
    np.testing.assert_allclose(_n(v), _n(p.var(xt)), atol=1e-10)
    # cross-cov consistency and symmetry
    zt = _t(np.linspace(-1, 1, 5))
    np.testing.assert_allclose(_n(p.cov(xt, zt)), _n(p.cov(zt, xt)).T, atol=1e-10)
    np.testing.assert_allclose(_n(p.cov(xt, xt)), _n(p.cov(xt)), atol=1e-8)
    # PSD
    assert np.linalg.eigvalsh(_n(p.cov(xt))).min() > -1e-8
    np.testing.assert_allclose(_n(agt.inducing_points(p)), _n(agt.as_inputs(_t(z))))
    # the whitened cache and every moment against the JAX package's
    for name in ("m_eps", "L_Lambda", "L_z", "alpha", "b_y", "B_ef"):
        np.testing.assert_allclose(_n(getattr(p.data, name)), np.asarray(getattr(pj.data, name)),
                                   rtol=1e-10, atol=1e-12)
    xj, zj = jnp.asarray(_n(xt)), jnp.asarray(_n(zt))
    np.testing.assert_allclose(_n(m2), np.asarray(pj.mean_and_var(xj)[0]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_n(v), np.asarray(pj.mean_and_var(xj)[1]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_n(C), np.asarray(pj.mean_and_cov(xj)[1]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_n(p.cov(xt, zt)), np.asarray(pj.cov(xj, zj)), rtol=1e-10,
                               atol=1e-12)


def test_variance_clamped_at_zero():
    # the max(v, 0) clamps: a test point on an inducing point with jitter 0
    # and tiny noise can round below zero; var and mean_and_var return ≥ 0
    f = agt.GP(agt.SqExponentialKernel())
    x = torch.linspace(-1, 1, 9, dtype=F64)
    p = agt.posterior(agt.VFE(f(x, 0.0)), f(x, 1e-12), torch.sin(x))
    assert bool((p.var(x) >= 0).all()) and bool((p.mean_and_var(x)[1] >= 0).all())


def test_update_posterior_new_observations(rng):
    # online ≡ batch for the new-observations path
    # (test/sparse_approximations.jl:32-55), and against the JAX update
    z = np.linspace(-3.0, 3.0, 8)
    x1, x2 = np.sort(rng.uniform(-3, 3, 12)), np.sort(rng.uniform(-3, 3, 7))
    y1, y2 = rng.standard_normal(12), rng.standard_normal(7)
    f, fj = agt.GP(agt.SqExponentialKernel()), agp.GP(agp.SqExponentialKernel())

    vfe = agt.VFE(f(_t(z), JITTER))
    p1 = agt.posterior(vfe, f(_t(x1), 0.1), _t(y1))
    p_online = agt.update_posterior(p1, f(_t(x2), 0.1), _t(y2))
    x_all, y_all = np.concatenate([x1, x2]), np.concatenate([y1, y2])
    p_batch = agt.posterior(vfe, f(_t(x_all), 0.1), _t(y_all))

    @jax.jit
    def jax_update(zz, xa, ya, xb, yb, xs):
        pj = agp.posterior(agp.VFE(fj(zz, JITTER)), fj(xa, 0.1), ya)
        pj = agp.update_posterior(pj, fj(xb, 0.1), yb)
        return pj.mean(xs), pj.cov(xs), pj.data.L_Lambda

    xt = np.linspace(-2, 2, 9)
    *want, L_j = jax_update(*(jnp.asarray(a) for a in (z, x1, y1, x2, y2, xt)))
    for name, w in zip(("mean", "cov"), want):
        got = _n(getattr(p_online, name)(_t(xt)))
        np.testing.assert_allclose(got, _n(getattr(p_batch, name)(_t(xt))), atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_n(p_online.data.m_eps), _n(p_batch.data.m_eps), atol=1e-6)
    np.testing.assert_allclose(_n(p_online.data.L_Lambda), np.asarray(L_j),
                               rtol=1e-10, atol=1e-12)
    assert isinstance(p_online.data.Sigma_y, agt.DiagonalNoise)
    assert p_online.data.x.shape == (19, 1)


def test_update_posterior_new_pseudopoints(rng):
    # online ≡ batch for the add-pseudo-points path
    # (test/sparse_approximations.jl:57-84), and against the JAX update
    z1, z2 = np.linspace(-3.0, 3.0, 6), np.asarray([-2.2, 0.3, 1.7])
    x, y = np.sort(rng.uniform(-3, 3, 15)), rng.standard_normal(15)
    f, fj = agt.GP(agt.SqExponentialKernel()), agp.GP(agp.SqExponentialKernel())

    p1 = agt.posterior(agt.VFE(f(_t(z1), JITTER)), f(_t(x), 0.1), _t(y))
    p_online = agt.update_posterior(p1, f(_t(z2), JITTER))
    z_all = np.concatenate([z1, z2])
    p_batch = agt.posterior(agt.VFE(f(_t(z_all), JITTER)), f(_t(x), 0.1), _t(y))

    @jax.jit
    def jax_update(za, zb, xx, yy, xs):
        pj = agp.posterior(agp.VFE(fj(za, JITTER)), fj(xx, 0.1), yy)
        pj = agp.update_posterior(pj, fj(zb, JITTER))
        return pj.mean(xs), pj.cov(xs)

    xt = np.linspace(-2, 2, 9)
    want = jax_update(*(jnp.asarray(a) for a in (z1, z2, x, y, xt)))
    for name, w in zip(("mean", "cov"), want):
        got = _n(getattr(p_online, name)(_t(xt)))
        np.testing.assert_allclose(got, _n(getattr(p_batch, name)(_t(xt))), atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-9, atol=1e-11)
    assert isinstance(p_online.approx, agt.VFE)
    np.testing.assert_allclose(_n(agt.inducing_points(p_online))[:, 0], z_all)


def test_update_pseudopoints_keeps_the_jitter_divergence(rng):
    # C22 includes fz.noise (the documented divergence from the reference),
    # so update ≡ batch holds at a jitter that is far from negligible
    z1, z2 = np.linspace(-3.0, 3.0, 5), np.asarray([-1.1, 0.9])
    x, y = np.sort(rng.uniform(-3, 3, 20)), rng.standard_normal(20)
    f = agt.GP(agt.Matern52Kernel())
    p1 = agt.posterior(agt.DTC(f(_t(z1), 0.05)), f(_t(x), 0.1), _t(y))
    p_online = agt.update_posterior(p1, f(_t(z2), 0.05))
    assert isinstance(p_online.approx, agt.DTC)
    p_batch = agt.posterior(agt.DTC(f(_t(np.concatenate([z1, z2])), 0.05)), f(_t(x), 0.1), _t(y))
    xt = _t(np.linspace(-2, 2, 9))
    np.testing.assert_allclose(_n(p_online.mean(xt)), _n(p_batch.mean(xt)), atol=1e-10)
    np.testing.assert_allclose(_n(p_online.var(xt)), _n(p_batch.var(xt)), atol=1e-10)


def _ard_parts(lib, s2, ard, noise, z, x, jitter):
    k = lib.compose(lib.SqExponentialKernel(), lib.ARDTransform(1.0 / ard)) * s2
    g = lib.GP(k)
    return lib.VFE(g(z, jitter)), g(x, noise)


def test_elbo_differentiable_matches_jax_grad(rng):
    # the JAX test's gradient check (there against finite differences),
    # here torch.autograd.grad against jax.grad at f64, with respect to σ²,
    # the ARD lengthscales, the noise and z
    x = rng.uniform(-2, 2, (25, 2))
    z = rng.uniform(-2, 2, (7, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(25)
    vals = dict(s2=1.3, ard=np.array([0.9, 1.4]), noise=0.1, z=z)

    def jax_fn(s2, ard, noise, zz):
        vfe, fx = _ard_parts(agp, s2, ard, noise, zz, jnp.asarray(x), 1e-8)
        return agp.elbo(vfe, fx, jnp.asarray(y))

    jv = [jnp.asarray(vals[k]) for k in ("s2", "ard", "noise", "z")]
    want_val, want = jax.jit(jax.value_and_grad(jax_fn, argnums=(0, 1, 2, 3)))(*jv)
    tv = [_t(vals[k]).requires_grad_() for k in ("s2", "ard", "noise", "z")]
    vfe, fx = _ard_parts(agt, *tv[:3], tv[3], _t(x), 1e-8)
    e = agt.elbo(vfe, fx, _t(y))
    got = torch.autograd.grad(e, tv)
    np.testing.assert_allclose(_f(e.detach()), _f(want_val), rtol=1e-10)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_n(g), np.asarray(w), rtol=1e-8, atol=1e-10)


def test_elbo_dtype_stability(rng):
    # (test/sparse_approximations.jl:103-118)
    for dt in (torch.float32, torch.float64):
        x, y, z = (torch.as_tensor(rng.standard_normal(k), dtype=dt) for k in (10, 10, 4))
        f = agt.GP(agt.SqExponentialKernel())
        e = agt.elbo(agt.VFE(f(z, torch.tensor(1e-6, dtype=dt))), f(x, torch.tensor(0.1, dtype=dt)),
                     y)
        assert e.dtype == dt


def test_heteroscedastic_noise_matches_jax(rng):
    # a per-point noise vector: DiagonalNoise through solve_sqrt, logdet and
    # tr_solve, in the ELBO and the posterior
    x, y, z = _setup(rng, n=20, m=6)
    noise = rng.uniform(0.05, 0.3, 20)
    f, fj = agt.GP(agt.Matern32Kernel()), agp.GP(agp.Matern32Kernel())
    vfe, fx = agt.VFE(f(_t(z), 1e-6)), f(_t(x), _t(noise))
    xt = np.linspace(-2, 2, 5)

    @jax.jit
    def jax_side(zz, xx, nn, yy, xs):
        vfe_j, fxj = agp.VFE(fj(zz, 1e-6)), fj(xx, nn)
        return agp.elbo(vfe_j, fxj, yy), *agp.posterior(vfe_j, fxj, yy).mean_and_var(xs)

    e_j, mj, vj = jax_side(*(jnp.asarray(a) for a in (z, x, noise, y, xt)))
    np.testing.assert_allclose(_f(agt.elbo(vfe, fx, _t(y))), _f(e_j), rtol=1e-10)
    m, v = agt.posterior(vfe, fx, _t(y)).mean_and_var(_t(xt))
    np.testing.assert_allclose(_n(m), np.asarray(mj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_n(v), np.asarray(vj), rtol=1e-10, atol=1e-12)


def test_neg_elbo_matches_jax(rng):
    # the sparse-VI objective over a tagged tree, value and gradient
    x, y, z = _setup(rng, n=24, m=6)

    def build(lib):
        def parts(c, xx):
            k = c["s2"] * lib.with_lengthscale(lib.SqExponentialKernel(), c["ell"])
            g = lib.GP(k)
            return lib.VFE(g(c["z"], 1e-8)), g(xx, c["noise"])
        return parts

    theta_j = {"s2": JP.positive(1.2), "ell": JP.positive(0.8), "noise": JP.positive(0.1),
               "z": jnp.asarray(z)}
    loss_j = jax_neg_elbo(build(agp), jnp.asarray(x), jnp.asarray(y))
    val_j, g_j = jax.jit(jax.value_and_grad(loss_j))(theta_j)
    theta_t = agt.params_from_numpy(param_tree(theta_j), device="cpu")
    loss_t = agt.neg_elbo(build(agt), _t(x), _t(y))(theta_t)
    g_t = torch.autograd.grad(loss_t, P.leaves(theta_t))
    np.testing.assert_allclose(_f(loss_t.detach()), _f(val_j), rtol=1e-10)
    for g, w in zip(g_t, jax.tree_util.tree_leaves(JP.unconstrain(g_j))):
        np.testing.assert_allclose(_n(g), np.asarray(w), rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# f32 through the kernel paths (interpret mode, small sizes)
# ---------------------------------------------------------------------------

KN, KM, KD = 150, 40, 3  # a 150×40 cross gram and a 40² gram take the fused gram


def _kernel_path_data():
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 4, (KN, KD)).astype(np.float32)
    z = x[rng.choice(KN, KM, replace=False)]
    y = (np.sin(x) @ np.exp(-np.arange(KD) / 2.0) + 0.2 * rng.standard_normal(KN)).astype(
        np.float32)
    vals = dict(s2=np.float32(1.1), ard=np.array([0.9, 1.2, 1.5], np.float32),
                noise=np.float32(0.05), z=z)
    return x, y, vals


@pytest.fixture(scope="module")
def jax_kernel_path():
    x, y, vals = _kernel_path_data()

    def fn(s2, ard, noise, zz):
        vfe, fx = _ard_parts(agp, s2, ard, noise, zz, jnp.asarray(x), jnp.float32(1e-6))
        return agp.elbo(vfe, fx, jnp.asarray(y))

    jv = [jnp.asarray(vals[k]) for k in ("s2", "ard", "noise", "z")]
    with small_kernel_paths():
        val, grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2, 3)))(*jv)
    return _f(val), [np.asarray(g) for g in grads]


def test_collapsed_elbo_kernel_path_f32_matches_jax(jax_kernel_path, monkeypatch):
    # the fused gram (cross and sym) forward and its VJP in all three modes,
    # the blocked Cholesky of Kzz and Λ and the wide solve, at f32; tolerance
    # ~1e-4 relative: two f32 evaluations in another op order, with κ(Λ)
    # ~ 1e3 at these sizes
    x, y, vals = _kernel_path_data()
    calls = {"gram_tile": [], "gram_bwd": []}
    for name in calls:
        orig = getattr(fused_gram, name)
        monkeypatch.setattr(fused_gram, name, lambda *a, _o=orig, _n=name, **k: (
            calls[_n].append(k.get("mode", a[6] if len(a) > 6 else "plain")) or _o(*a, **k)))
    with small_kernel_paths():
        tv = [torch.as_tensor(vals[k]).requires_grad_() for k in ("s2", "ard", "noise", "z")]
        vfe, fx = _ard_parts(agt, *tv, torch.as_tensor(x), torch.tensor(1e-6))
        e = agt.elbo(vfe, fx, torch.as_tensor(y))
        got = torch.autograd.grad(e, tv)
    want_val, want = jax_kernel_path
    assert e.dtype == torch.float32
    assert len(calls["gram_tile"]) == 2
    assert sorted(calls["gram_bwd"]) == ["plain", "sym", "transpose"]
    np.testing.assert_allclose(_f(e.detach()), want_val, rtol=2e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_n(g), w, rtol=2e-3, atol=2e-3 * np.abs(w).max())
