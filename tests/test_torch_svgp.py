"""The port's stochastic variational GP (``models/svgp.py``) against the JAX
package and against the oracles of ``tests/test_svgp.py``.

- f64: the same inputs, made from a seed with numpy, go through both
  packages; ELBOs, optimal variational parameters, natural-gradient steps
  and predictions agree to 1e-8 relative or better. The training loops'
  traces agree over 5 steps, with the JAX package's minibatch indices
  (``jax.random.randint`` over ``jax.random.split(key, steps)``) replayed
  through a draws object.
- f32 through the kernel paths of both packages in interpret mode at small
  sizes: the gradient of one joint SVGP step (σ², ARD lengthscales, noise,
  z, m, C_raw from a constrained tree, as ``examples/sparse_vfe_50k.py``
  trains them) beside ``jax.grad``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import gammaln
from torch_port_helpers import kernel_tree, param_tree, small_kernel_paths

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu import params as JP
from abstractgps_tpu.models import svgp as jsv
from abstractgps_tpu_torch import params as P
from abstractgps_tpu_torch.models import svgp as tsv
from abstractgps_tpu_torch.ops import distance, fused_gram

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


class JaxMinibatches:
    """Replays the JAX training loops' minibatch indices:
    ``jax.random.randint(k, (batch,), 0, n)`` over ``jax.random.split(key,
    steps)``, one key a step."""

    def __init__(self, key, steps):
        self.keys = jax.random.split(key, steps)
        self.step = 0

    def indices(self, n, batch_size, device):
        idx = jax.random.randint(self.keys[self.step], (batch_size,), 0, n)
        self.step += 1
        return torch.as_tensor(np.array(idx), device=device)


@pytest.fixture()
def setup(rng):
    n, m, d = 60, 12, 2
    x = rng.uniform(size=(n, d))
    z = rng.uniform(size=(m, d))
    y = rng.normal(size=(n,))
    return x, z, y


def _kern(lib):
    return lib.with_lengthscale(lib.SqExponentialKernel(), 0.5) * 1.3


def _pair(x, z, jitter=jsv.DEFAULT_INDUCING_JITTER):
    """The same fresh SVGP in both packages."""
    return (jsv.svgp_init(_kern(agp), jnp.asarray(z), jitter=jitter),
            tsv.svgp_init(_kern(agt), _t(z), jitter=jitter))


def _close_sv(sv_t, sv_j, rtol, atol=None):
    for name in ("z", "m", "C_raw"):
        np.testing.assert_allclose(_n(getattr(sv_t, name)), np.asarray(getattr(sv_j, name)),
                                   rtol=rtol, atol=rtol if atol is None else atol)


def test_optimal_params_recover_collapsed_vfe(setup):
    x, z, y = setup
    noise = 0.25
    sv_j, sv = _pair(x, z, jitter=1e-10)
    m_opt, C_opt = tsv.optimal_variational_params(sv, _t(x), _t(y), noise)
    mj, Cj = jax.jit(jsv.optimal_variational_params, static_argnums=3)(
        sv_j, jnp.asarray(x), jnp.asarray(y), noise)
    np.testing.assert_allclose(_n(m_opt), np.asarray(mj), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(_n(C_opt), np.asarray(Cj), rtol=1e-9, atol=1e-10)
    got = tsv.svgp_elbo(tsv.set_variational(sv, m_opt, C_opt), _t(x), _t(y), noise)
    f = agt.GP(_kern(agt))
    want = agt.elbo(agt.VFE(f(_t(z), 1e-10)), f(_t(x), noise), _t(y))
    np.testing.assert_allclose(_f(got.detach()), _f(want.detach()), rtol=1e-8)


def test_optimal_posterior_matches_vfe_posterior(setup, rng):
    x, z, y = setup
    noise = 0.3
    sv_j, sv = _pair(x, z, jitter=1e-10)
    sv = tsv.set_variational(sv, *tsv.optimal_variational_params(sv, _t(x), _t(y), noise))
    post = tsv.svgp_posterior(sv)
    f = agt.GP(_kern(agt))
    vfe_post = agt.posterior(agt.VFE(f(_t(z), 1e-10)), f(_t(x), noise), _t(y))
    xs = rng.uniform(size=(20, x.shape[1]))

    @jax.jit
    def jax_moments(sv_j, xx, yy, xq, xc):
        sv_j = jsv.set_variational(sv_j, *jsv.optimal_variational_params(sv_j, xx, yy, noise))
        post_j = jsv.svgp_posterior(sv_j)
        return post_j.mean(xq), post_j.var(xq), post_j.cov(xq), post_j.cov(xq, xc)

    *want, cross_j = jax_moments(sv_j, *(jnp.asarray(a) for a in (x, y, xs, x[:7])))
    for name, rtol, w in zip(("mean", "var", "cov"), (1e-6, 1e-6, 1e-5), want):
        got = _n(getattr(post, name)(_t(xs)))
        np.testing.assert_allclose(got, _n(getattr(vfe_post, name)(_t(xs))), rtol=rtol, atol=1e-8)
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(_n(post.cov(_t(xs), _t(x[:7]))), np.asarray(cross_j),
                               rtol=1e-9, atol=1e-11)


def test_elbo_lower_bounds_logpdf_and_matches_jax(setup):
    x, z, y = setup
    noise = 0.2
    sv_j, sv = _pair(x, z)
    lp = _f(agt.GP(_kern(agt))(_t(x), noise).logpdf(_t(y)))
    e = tsv.svgp_elbo(sv, _t(x), _t(y), noise)
    assert _f(e) <= lp
    np.testing.assert_allclose(_f(e), _f(jsv.svgp_elbo(sv_j, jnp.asarray(x),
                                                             jnp.asarray(y), noise)), rtol=1e-10)
    sv_opt = tsv.set_variational(sv, *tsv.optimal_variational_params(sv, _t(x), _t(y), noise))
    assert _f(tsv.svgp_elbo(sv_opt, _t(x), _t(y), noise)) <= lp + 1e-8
    np.testing.assert_allclose(_f(sv.kl()), 0.0, atol=1e-12)


def test_minibatch_estimator_is_unbiased_over_partition(setup):
    x, z, y = setup
    noise = 0.25
    _, sv = _pair(x, z)
    n = x.shape[0]
    full = _f(tsv.svgp_elbo(sv, _t(x), _t(y), noise))
    halves = [_f(tsv.svgp_elbo(sv, _t(x[s]), _t(y[s]), noise, n_total=n))
              for s in (slice(None, n // 2), slice(n // 2, None))]
    np.testing.assert_allclose(sum(halves) / 2.0, full, rtol=1e-10)


def test_quadrature_matches_gaussian_closed_form(setup):
    x, z, y = setup
    noise = 0.4
    _, sv = _pair(x, z)
    sv = tsv.set_variational(sv, *tsv.optimal_variational_params(sv, _t(x), _t(y), noise))

    def gauss_loglik(f, yy):
        return -0.5 * (np.log(2.0 * np.pi * noise) + (yy - f) ** 2 / noise)

    got = tsv.svgp_elbo_quadrature(sv, _t(x), _t(y), gauss_loglik, num_points=30)
    want = tsv.svgp_elbo(sv, _t(x), _t(y), noise)
    np.testing.assert_allclose(_f(got), _f(want), rtol=1e-7)


def test_gauss_hermite_linear_quadratic_exact_and_matches_jax(rng):
    mu, var = rng.normal(size=(7,)), rng.uniform(0.1, 2.0, size=(7,))
    y = np.zeros((7,))
    lin = tsv.gauss_hermite_expectation(lambda f, y: f, _t(mu), _t(var), _t(y), num_points=10)
    np.testing.assert_allclose(_n(lin), mu, rtol=1e-6)
    quad = tsv.gauss_hermite_expectation(lambda f, y: f * f, _t(mu), _t(var), _t(y), num_points=10)
    np.testing.assert_allclose(_n(quad), mu ** 2 + var, rtol=1e-6)
    cubic = tsv.gauss_hermite_expectation(lambda f, y: torch.exp(f) * (y + 1.0), _t(mu),
                                          _t(var), _t(y), num_points=12)
    want = jsv.gauss_hermite_expectation(lambda f, y: jnp.exp(f) * (y + 1.0), jnp.asarray(mu),
                                         jnp.asarray(var), jnp.asarray(y), num_points=12)
    np.testing.assert_allclose(_n(cubic), np.asarray(want), rtol=1e-12)


def test_svgp_posterior_composes_with_finite_gp(setup, rng):
    # posteriors-are-GPs: project, sample, take logpdf
    x, z, y = setup
    _, sv = _pair(x, z)
    sv = tsv.set_variational(sv, *tsv.optimal_variational_params(sv, _t(x), _t(y), 0.3))
    fx = tsv.svgp_posterior(sv)(_t(rng.uniform(size=(9, x.shape[1]))), 1e-6)
    s = fx.rand(torch.Generator().manual_seed(2))
    assert s.shape == (9,)
    assert np.isfinite(_f(fx.logpdf(s)))


def test_svgp_float32_stability(setup):
    x, z, y = setup
    kern32 = agt.with_lengthscale(agt.SqExponentialKernel(), 0.5).to(torch.float32) * \
        torch.tensor(1.3)
    sv = tsv.svgp_init(kern32, _t(z, torch.float32))
    val = tsv.svgp_elbo(sv, _t(x, torch.float32), _t(y, torch.float32), torch.tensor(0.2))
    assert val.dtype == torch.float32 and np.isfinite(_f(val))
    assert sv.m.dtype == sv.C_raw.dtype == sv.jitter.dtype == torch.float32


def test_natgrad_step_lr1_lands_on_optimum_and_matches_jax(setup):
    # Gaussian likelihood + full batch: ONE natural-gradient step with lr=1
    # from any start equals the closed-form optimum (Salimbeni et al. 2018)
    x, z, y = setup
    sv_j, sv = _pair(x, z)
    m0 = 2.0 * np.random.default_rng(3).normal(size=z.shape[0])
    C0 = 0.3 * np.eye(z.shape[0])
    sv = tsv.set_variational(sv, _t(m0), _t(C0))
    sv_j = jsv.set_variational(sv_j, jnp.asarray(m0), jnp.asarray(C0))

    stepped = tsv.natgrad_step(sv, _t(x), _t(y), 0.1, lr=1.0)
    m_star, C_star = tsv.optimal_variational_params(sv, _t(x), _t(y), 0.1)
    np.testing.assert_allclose(_n(stepped.m), _n(m_star), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(_n(stepped.C @ stepped.C.T), _n(C_star @ C_star.T),
                               rtol=1e-8, atol=1e-8)
    got = _f(tsv.svgp_elbo(stepped, _t(x), _t(y), 0.1))
    f = agt.GP(_kern(agt))
    want = _f(agt.elbo(agt.VFE(f(_t(z), _f(sv.jitter))), f(_t(x), 0.1), _t(y)))
    np.testing.assert_allclose(got, want, rtol=1e-8)
    # a partial step (lr 0.3) against the JAX package's
    part = tsv.natgrad_step(sv, _t(x), _t(y), 0.1, lr=0.3)
    part_j = jax.jit(lambda sv_, xx, yy: jsv.natgrad_step(sv_, xx, yy, 0.1, lr=0.3))(
        sv_j, jnp.asarray(x), jnp.asarray(y))
    _close_sv(part, part_j, 1e-9)


def _poisson_t(f, yy):
    return yy * f - torch.exp(f) - torch.lgamma(yy + 1.0)


def _poisson_j(f, yy):
    return yy * f - jnp.exp(f) - gammaln(yy + 1.0)


def test_natgrad_step_quadrature_improves_elbo_and_matches_jax(setup, rng):
    x, z, _ = setup
    y = rng.poisson(np.exp(rng.normal(size=(x.shape[0],)) * 0.3)).astype(np.float64)
    sv_j, sv = _pair(x, z)
    e0 = _f(tsv.svgp_elbo_quadrature(sv, _t(x), _t(y), _poisson_t))
    for _ in range(5):
        sv = tsv.natgrad_step(sv, _t(x), _t(y), lr=0.2, log_lik=_poisson_t)
        sv_j = jsv.natgrad_step(sv_j, jnp.asarray(x), jnp.asarray(y), lr=0.2, log_lik=_poisson_j)
    e1 = _f(tsv.svgp_elbo_quadrature(sv, _t(x), _t(y), _poisson_t))
    assert np.isfinite(e1) and e1 > e0
    _close_sv(sv, sv_j, 1e-8)


def test_fit_svgp_improves_elbo(setup):
    x, z, y = setup
    noise = 0.25
    _, sv0 = _pair(x, z)
    before = _f(tsv.svgp_elbo(sv0, _t(x), _t(y), noise))
    sv, trace = tsv.fit_svgp(0, sv0, _t(x), _t(y), noise, batch_size=16, steps=200,
                             learning_rate=5e-2)
    after = _f(tsv.svgp_elbo(sv, _t(x), _t(y), noise))
    assert after > before
    assert np.isfinite(_n(trace)).all() and trace.shape == (200,)
    # below the optimal collapsed bound at these inducing points, within
    # striking distance of it
    f = agt.GP(_kern(agt))
    opt = _f(agt.elbo(agt.VFE(f(_t(z), _f(sv0.jitter))), f(_t(x), noise), _t(y)))
    assert after <= opt + 1e-6
    assert after > opt - 0.25 * abs(opt)
    # the input SVGP is left as it was, and frozen fields stay put
    assert _f(sv0.m.abs().max()) == 0.0
    assert sv.kernel is sv0.kernel and _f(sv.jitter) == _f(sv0.jitter)


@pytest.mark.parametrize("case", ["gaussian", "frozen_z", "hyper", "poisson", "hetero"])
def test_fit_svgp_trace_matches_jax(setup, case):
    # 5 Adam steps with the JAX package's minibatch indices replayed
    x, z, y = setup
    sv_j, sv = _pair(x, z)
    noise, kw, kw_j = 0.25, {}, {}
    if case == "frozen_z":
        kw = kw_j = {"train_inducing": False}
    elif case == "hyper":
        kw = kw_j = {"train_hyper": True}
    elif case == "poisson":
        y = np.random.default_rng(4).poisson(1.5, size=y.shape).astype(np.float64)
        noise, kw, kw_j = None, {"log_lik": _poisson_t}, {"log_lik": _poisson_j}
    elif case == "hetero":
        # per-point noise is sliced with the minibatch
        noise = np.random.default_rng(5).uniform(0.05, 0.3, size=y.shape)
    key = jax.random.PRNGKey(0)
    fit_j, trace_j = jsv.fit_svgp(key, sv_j, jnp.asarray(x), jnp.asarray(y),
                                  None if noise is None else jnp.asarray(noise), batch_size=16,
                                  steps=5, learning_rate=5e-2, **kw_j)
    fit_t, trace_t = tsv.fit_svgp(JaxMinibatches(key, 5), sv, _t(x), _t(y),
                                  None if noise is None else _t(noise), batch_size=16,
                                  steps=5, learning_rate=5e-2, **kw)
    # Adam divides each gradient entry by its own magnitude: an entry whose
    # exact gradient is ~0 (e.g. z and parts of C at q = prior) moves by
    # lr·(rounding ~1e-14)/(eps 1e-8) ~ 5e-8 a step, with another sign in
    # each package. Tolerances: 1e-7 relative on the trace, 1e-6 absolute
    # on the state after 5 steps
    np.testing.assert_allclose(_n(trace_t), np.asarray(trace_j), rtol=1e-7)
    _close_sv(fit_t, fit_j, 1e-7, atol=1e-6)
    if case == "hyper":
        s2_j = fit_j.kernel.variance
        np.testing.assert_allclose(_f(fit_t.kernel.variance), _f(s2_j), rtol=1e-8)
        assert _f(sv.kernel.variance) == 1.3  # the caller's kernel is untouched


@pytest.mark.parametrize("case", ["gaussian", "hetero", "frozen_z"])
def test_fit_svgp_natgrad_trace_matches_jax(setup, case):
    x, z, y = setup
    sv_j, sv = _pair(x, z)
    noise = 0.1 if case != "hetero" else np.random.default_rng(6).uniform(0.05, 0.3, y.shape)
    kw = {"train_inducing": False} if case == "frozen_z" else {}
    key = jax.random.PRNGKey(1)
    fit_j, trace_j = jsv.fit_svgp_natgrad(key, sv_j, jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(noise), batch_size=30, steps=5,
                                          natgrad_lr=0.5, hyper_lr=5e-3, **kw)
    fit_t, trace_t = tsv.fit_svgp_natgrad(JaxMinibatches(key, 5), sv, _t(x), _t(y), _t(noise),
                                          batch_size=30, steps=5, natgrad_lr=0.5,
                                          hyper_lr=5e-3, **kw)
    np.testing.assert_allclose(_n(trace_t), np.asarray(trace_j), rtol=1e-9)
    _close_sv(fit_t, fit_j, 1e-8)
    assert _f(fit_t.m.abs().max()) > 1e-3  # the variational params moved


def test_fit_svgp_natgrad_improves(setup):
    x, z, y = setup
    _, sv = _pair(x, z)
    e0 = _f(tsv.svgp_elbo(sv, _t(x), _t(y), 0.1))
    fitted, trace = tsv.fit_svgp_natgrad(torch.Generator().manual_seed(0), sv, _t(x), _t(y),
                                         0.1, batch_size=30, steps=40, natgrad_lr=0.5,
                                         hyper_lr=5e-3)
    e1 = _f(tsv.svgp_elbo(fitted, _t(x), _t(y), 0.1))
    assert np.isfinite(e1) and e1 > e0 and trace.shape == (40,)


def test_svgp_from_numpy_carries_the_state(setup):
    x, z, y = setup
    sv_j, _ = _pair(x, z)
    sv_j = jsv.set_variational(sv_j, *jsv.optimal_variational_params(
        sv_j, jnp.asarray(x), jnp.asarray(y), 0.2))
    tree = {"kernel": kernel_tree(sv_j.kernel), "mean": {"type": "ZeroMean"},
            **{k: np.asarray(getattr(sv_j, k)) for k in ("z", "m", "C_raw", "jitter")}}
    sv = agt.svgp_from_numpy(tree)
    assert sv.z.device.type == "cpu" and sv.m.dtype == F64
    np.testing.assert_allclose(_f(tsv.svgp_elbo(sv, _t(x), _t(y), 0.2)),
                               _f(jsv.svgp_elbo(sv_j, jnp.asarray(x), jnp.asarray(y), 0.2)),
                               rtol=1e-10)


def test_public_surface():
    for name in ("SVGP", "SVGPPosterior", "fit_svgp", "fit_svgp_natgrad", "natgrad_step",
                 "svgp_elbo", "svgp_elbo_quadrature", "svgp_init", "svgp_posterior", "VFE",
                 "DTC", "ApproxPosteriorGP", "elbo", "inducing_points", "update_posterior",
                 "dtc", "neg_elbo"):
        assert hasattr(agt, name), name


# ---------------------------------------------------------------------------
# f32 through the kernel paths (interpret mode, small sizes): one joint step
# ---------------------------------------------------------------------------

SN, SM, SD, SB = 300, 40, 3, 64  # 40×64 cross gram, 40² gram: both fused


def _step_data():
    rng = np.random.default_rng(8)
    x = (rng.uniform(size=(SN, SD)) * 4.0).astype(np.float32)
    y = (np.sin(x) @ np.exp(-np.arange(SD) / 2.0) + 0.3 * np.cos(2.0 * x[:, 0])
         + 0.2 * rng.standard_normal(SN)).astype(np.float32)
    z0 = x[rng.choice(SN, SM, replace=False)]
    idx = rng.integers(0, SN, SB)
    # q(ε) away from the prior: at m = 0, C = I the ELBO does not depend on
    # z or the lengthscales
    m0 = (0.3 * rng.standard_normal(SM)).astype(np.float32)
    C0 = np.tril(0.02 * rng.standard_normal((SM, SM)), -1) + 0.5 * np.eye(SM)
    c_raw0 = _n(tsv._raw_from_tril(torch.as_tensor(C0))).astype(np.float32)
    return x, y, z0, idx, m0, c_raw0


def _theta(lib_params, z0, m0, c_raw0):
    return {"s2": lib_params.positive(np.float32(1.0)),
            "ard": lib_params.positive(np.ones(SD, np.float32)),
            "noise2": lib_params.positive(np.float32(0.1)),
            "z": z0, "m": m0, "C_raw": c_raw0}


@pytest.fixture(scope="module")
def jax_step():
    x, y, z0, idx, m0, c_raw0 = _step_data()
    template = jsv.svgp_init(agp.SqExponentialKernel(), jnp.asarray(z0))
    theta = _theta(JP, *(jnp.asarray(a) for a in (z0, m0, c_raw0)))
    theta = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), theta)

    def loss(th):
        c = JP.constrain(th)
        kern = agp.compose(agp.SqExponentialKernel(), agp.ARDTransform(1.0 / c["ard"])) * c["s2"]
        sv = dataclasses.replace(template, kernel=kern, z=c["z"], m=c["m"], C_raw=c["C_raw"])
        return -jsv.svgp_elbo(sv, jnp.asarray(x[idx]), jnp.asarray(y[idx]), c["noise2"],
                              n_total=SN)

    with small_kernel_paths():
        val, g = jax.jit(jax.value_and_grad(loss))(theta)
    return theta, _f(val), g


def test_joint_svgp_step_kernel_path_f32_matches_jax(jax_step, monkeypatch):
    # σ²·SE∘ARD rebuilt from a constrained tree; z enters Kzz and the cross
    # gram, so autograd adds two gram_bwd results (sym and plain) for it, and
    # the ARD-scaled batch takes the transposed mode. Tolerance: f32 with
    # sums in another order, ~1e-3 of each leaf's largest entry
    theta_j, want_val, want = jax_step
    x, y, _, idx, _, _ = _step_data()
    modes = []
    orig = fused_gram.gram_bwd
    monkeypatch.setattr(fused_gram, "gram_bwd",
                        lambda *a: modes.append(a[6]) or orig(*a))
    with small_kernel_paths():
        theta = agt.params_from_numpy(param_tree(theta_j), device="cpu", dtype=torch.float32)
        template = tsv.svgp_init(agt.SqExponentialKernel(), theta["z"].detach())

        c = P.constrain(theta)
        kern = agt.compose(agt.SqExponentialKernel(), agt.ARDTransform(1.0 / c["ard"])) * c["s2"]
        sv = template.replace(kernel=kern, z=c["z"], m=c["m"], C_raw=c["C_raw"])
        loss = -tsv.svgp_elbo(sv, torch.as_tensor(x[idx]), torch.as_tensor(y[idx]),
                              c["noise2"], n_total=SN)
        got = torch.autograd.grad(loss, P.leaves(theta))
    assert loss.dtype == torch.float32
    assert sorted(modes) == ["plain", "sym", "transpose"]
    np.testing.assert_allclose(_f(loss.detach()), want_val, rtol=2e-5)
    for g, w in zip(got, jax.tree_util.tree_leaves(JP.unconstrain(want))):
        w = np.asarray(w)
        np.testing.assert_allclose(_n(g), w, rtol=2e-3, atol=2e-3 * np.abs(w).max())
