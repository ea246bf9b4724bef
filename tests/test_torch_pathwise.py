"""The port's pathwise posterior sampling (``models/pathwise.py``) against the
JAX package and against the statistical oracles of ``tests/test_pathwise.py``.

- Same draws: the JAX function's random draws are recorded and replayed
  through the port's draws object (``JaxDraws``), so both build the same
  features and the same paths from the same f64 inputs. Features agree to
  1e-12 (the same closed forms), paths to 1e-9 relative (the posterior's
  solve in another op order).
- Moments: the port's own generator, many samples, empirical moments
  against the exact posterior (or the kernel), within the JAX tests'
  Monte Carlo bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import JaxDraws, kernel_tree, record_jax_draws

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu.models import pathwise as jpw
from abstractgps_tpu_torch.models import pathwise as tpw
from abstractgps_tpu_torch.ops import distance

F64 = torch.float64


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


def _n(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _port(kernel_j):
    return agt.kernel_from_numpy(kernel_tree(kernel_j), device="cpu")


def _features_tree(ff):
    """A JAX feature map as ``fourier_features_from_numpy`` takes it."""
    out = {"transforms": [kernel_tree(t) for t in ff.transforms]}
    if isinstance(ff, jpw._ConcatFeatures):
        return dict(out, blocks=[_features_tree(b) for b in ff.blocks])
    return dict(out, omega=np.asarray(ff.omega), bias=np.asarray(ff.bias),
                weights=np.asarray(ff.weights))


KERNELS = {
    "se": lambda: agp.SqExponentialKernel(),
    "m12": lambda: agp.ExponentialKernel(),
    "m32": lambda: agp.Matern32Kernel(),
    "m52": lambda: agp.Matern52Kernel(),
    "rq": lambda: agp.RationalQuadraticKernel(alpha=1.5),
    "scaled": lambda: 2.0 * agp.with_lengthscale(agp.SqExponentialKernel(), 0.7),
    "ard": lambda: 1.3 * agp.with_lengthscale(agp.Matern32Kernel(), jnp.array([0.5, 1.0, 2.0])),
    "product": lambda: (agp.with_lengthscale(agp.SqExponentialKernel(), 0.5)
                        * agp.with_lengthscale(agp.Matern32Kernel(), 2.0)),
    "sum": lambda: (0.5 * agp.SqExponentialKernel()
                    + 1.5 * agp.with_lengthscale(agp.Matern52Kernel(), 2.0)),
    "linear_in_product": lambda: (
        agp.compose(agp.SqExponentialKernel(), agp.LinearTransform(jnp.array([[1.0, 0.5, 0.0],
                                                                              [0.0, 1.0, 2.0]])))
        * agp.Matern52Kernel()),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_fourier_features_match_jax(name):
    kj = KERNELS[name]()
    x = np.random.default_rng(0).uniform(-1.0, 1.0, size=(9, 3))
    with record_jax_draws() as rec:
        ff_j = jpw.sample_fourier_features(kj, jax.random.PRNGKey(0), 16, 3)
    ff_t = tpw.sample_fourier_features(_port(kj), JaxDraws(rec), 16, 3, dtype=F64)
    assert type(ff_t).__name__ == type(ff_j).__name__
    assert ff_t.num_features == ff_j.num_features
    want = np.asarray(ff_j(jnp.asarray(x)))
    np.testing.assert_allclose(_n(ff_t(_t(x))), want, rtol=1e-12, atol=1e-12)
    # the JAX package's features carried across evaluate the same
    ff_c = agt.fourier_features_from_numpy(_features_tree(ff_j), device="cpu")
    np.testing.assert_allclose(_n(ff_c(_t(x))), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["se", "m32", "rq", "product", "sum"])
def test_rff_gram_approximates_kernel(name):
    """E[φ(x)φ(z)ᵀ] → k(x, z) as m → ∞ (MC error ~ 1/√m), as
    tests/test_pathwise.py:20-45 with the port's own generator."""
    k = _port(KERNELS[name]())
    x = torch.linspace(-2.0, 2.0, 9, dtype=F64)[:, None]
    K = agt.kernelmatrix(k, x)
    F = tpw.sample_fourier_features(k, 0, 60_000, 1, dtype=F64)(x)
    assert float((F @ F.T - K).abs().max()) < 0.05 * float(K.max())


@pytest.mark.parametrize("num_samples", [None, 3])
def test_prior_function_sample_matches_jax(num_samples):
    fj = agp.GP(0.5, 1.3 * agp.with_lengthscale(agp.Matern32Kernel(), 0.8))
    ft = agt.GP(0.5, _port(fj.kernel))
    x = np.linspace(0.0, 1.0, 6)[:, None]
    with record_jax_draws() as rec:
        hj = jpw.prior_function_sample(fj, jax.random.PRNGKey(1), 64, 1, num_samples=num_samples)
    ht = tpw.prior_function_sample(ft, JaxDraws(rec), 64, 1, num_samples=num_samples,
                                   dtype=F64)
    out = ht(_t(x))
    assert out.shape == ((6,) if num_samples is None else (6, 3))
    np.testing.assert_allclose(_n(out), np.asarray(hj(jnp.asarray(x))), rtol=1e-12, atol=1e-12)


def test_prior_function_sample_moments():
    f = agt.GP(0.5, _port(1.3 * agp.with_lengthscale(agp.Matern32Kernel(), 0.8)))
    x = torch.linspace(0.0, 1.0, 6, dtype=F64)[:, None]
    h = tpw.prior_function_sample(f, torch.Generator().manual_seed(1), 4096, 1,
                                  num_samples=4096, dtype=F64)
    S = _n(h(x))
    assert np.max(np.abs(S.mean(axis=1) - 0.5)) < 0.1
    assert np.max(np.abs(np.cov(S) - _n(agt.kernelmatrix(f.kernel, x)))) < 0.12


def _posteriors(noise_kind, n=24):
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0, 3, size=n))[:, None]
    y = rng.normal(size=n)
    fj = agp.GP(0.2, 1.1 * agp.with_lengthscale(agp.SqExponentialKernel(), 0.6))
    ft = agt.GP(0.2, _port(fj.kernel))
    if noise_kind == "dense":
        A = rng.normal(size=(n, n)) * 0.05
        S = A @ A.T + 0.05 * np.eye(n)
        nj, nt = agp.DenseNoise(jnp.asarray(S)), agt.DenseNoise(_t(S))
    else:
        nj, nt = 0.05, 0.05
    return (agp.posterior(fj(jnp.asarray(x), nj), jnp.asarray(y)),
            agt.posterior(ft(_t(x), nt), _t(y)))


@pytest.mark.parametrize("noise_kind", ["diag", "dense"])
def test_pathwise_sample_matches_jax(noise_kind):
    pj, pt = _posteriors(noise_kind)
    xs = np.linspace(-0.3, 3.3, 15)[:, None]
    with record_jax_draws() as rec:
        gj = jpw.pathwise_sample(pj, jax.random.PRNGKey(11), num_features=64, num_samples=5)
    gt = tpw.pathwise_sample(pt, JaxDraws(rec), num_features=64, num_samples=5)
    np.testing.assert_allclose(_n(gt(_t(xs))), np.asarray(gj(jnp.asarray(xs))),
                               rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("noise_kind", ["diag", "dense"])
def test_pathwise_posterior_moments_match_exact(noise_kind):
    # tests/test_pathwise.py:62-79 and :113-131: 8192 features, 6000 paths;
    # mean within 0.06, covariance within 0.08 (the O(1/√m) RFF truncation
    # plus the sampling spread of 6000 paths)
    _, pt = _posteriors(noise_kind)
    xs = torch.linspace(-0.3, 3.3, 15, dtype=F64)[:, None]
    m, C = pt.mean_and_cov(xs)
    g = tpw.pathwise_sample(pt, 11, num_features=8192, num_samples=6000)
    S = _n(g(xs))
    assert np.max(np.abs(S.mean(axis=1) - _n(m))) < 0.06
    assert np.max(np.abs(np.cov(S) - _n(C))) < 0.08


def test_pathwise_single_sample_shape_and_interpolation():
    rng = np.random.default_rng(5)
    x = _t(np.sort(rng.uniform(0, 2, size=16))[:, None])
    fx = agt.GP(agt.Matern52Kernel())(x, 1e-4)
    y = fx.rand(torch.Generator().manual_seed(2))
    g = tpw.pathwise_sample(agt.posterior(fx, y), 3, num_features=4096)
    out = g(x)
    assert out.shape == (16,)
    assert float((out - y).abs().max()) < 0.15  # every path nearly interpolates


def test_seed_generator_and_draws_give_the_same_paths():
    _, pt = _posteriors("diag")
    xs = torch.linspace(0.0, 3.0, 7, dtype=F64)[:, None]
    a = tpw.pathwise_sample(pt, 4, num_features=32, num_samples=2)(xs)
    b = tpw.pathwise_sample(pt, torch.Generator().manual_seed(4), num_features=32,
                            num_samples=2)(xs)
    c = tpw.pathwise_sample(pt, 5, num_features=32, num_samples=2)(xs)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_unsupported_kernels_raise():
    with pytest.raises(NotImplementedError, match="spectral"):
        tpw.sample_fourier_features(agt.PeriodicKernel(), 0, 8, 1, dtype=F64)
    inner = agt.compose(agt.SEKernel(), agt.FunctionTransform(None, lambda p, x: x ** 2))
    with pytest.raises(NotImplementedError, match="nonlinear"):
        tpw.sample_fourier_features(inner * agt.Matern32Kernel(), 0, 8, 1, dtype=F64)


def test_pathwise_needs_the_noise_record():
    _, pt = _posteriors("diag")
    bare = agt.PosteriorGP(pt.prior, type(pt.data)(pt.data.alpha, pt.data.L, pt.data.x,
                                                   pt.data.delta, None))
    with pytest.raises(NotImplementedError, match="noise"):
        tpw.pathwise_sample(bare, 0, num_features=8)
