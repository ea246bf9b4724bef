"""The port's Markov (state-space) backend (``models/markov.py``) against the
JAX package's, at f64 on the CPU, on the same numpy inputs.

Every case of ``tests/test_markov.py`` has its counterpart here, the
cases marked slow there included. The JAX sides run under ``jax.jit``.

Tolerances:

- logpdf, marginals, covariances, gradients: both packages run the same
  recursions in the same order (the port's associative scan is
  ``lax.associative_scan``'s odd/even recursion), so they agree to
  rounding: 1e-10 relative to the JAX value, or 1e-10 of its largest
  entry.
- Against the port's own dense path (the exact GP): the JAX tests' 1e-8
  (logpdf), 1e-7/1e-6 (mean/variance), 1e-6 (gradients).
- ``_stable_Q``: 64·eps·(|Q_ij| + √(P∞_ii P∞_jj)) entrywise; the incomplete
  gamma differs by a few ulps between the two libraries, and the c_k sums
  of the Matérn-5/2 entries cancel up to ~30 of them.
- FFBS samples with the JAX package's ε replayed: 1e-8 absolute; each step
  factors a conditional covariance that is singular up to the jitter
  100·eps·(tr + 1), where rounding of 1e-16 moves the factor by ~1e-9.
- f32 filters at dense sampling: the JAX package's f32 contract, 1e-3
  relative to the port's f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import JaxDraws, kernel_tree

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu.models import markov as jm
from abstractgps_tpu_torch.models import markov as tm
from abstractgps_tpu_torch.ops import distance

F64 = torch.float64
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


def _n(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _port(kernel_j):
    return agt.kernel_from_numpy(kernel_tree(kernel_j), device="cpu")


def _close(got, want, rtol=RTOL, atol_rel=RTOL):
    got, want = _n(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * scale)


KERNELS = {
    "m12": lambda: agp.ExponentialKernel(),
    "m32": lambda: agp.Matern32Kernel(),
    "m52": lambda: agp.Matern52Kernel(),
    "scaled_m32": lambda: 2.3 * agp.Matern32Kernel(),
    "ell_m52": lambda: agp.with_lengthscale(agp.Matern52Kernel(), 0.35),
    "scaled_ell_m12": lambda: 1.7 * agp.with_lengthscale(agp.ExponentialKernel(), 2.0),
    "sum": lambda: (agp.Matern32Kernel()
                    + 0.5 * agp.with_lengthscale(agp.Matern52Kernel(), 0.6)),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    n = 80
    return np.sort(rng.uniform(0.0, 6.0, size=n)), rng.normal(size=n)


def _jax_logpdf(kj, x, y, parallel, noise=0.1, mean=None):
    def f(x_, y_, noise_):
        gp = agp.GP(kj) if mean is None else agp.GP(mean, kj)
        return jm.markov_logpdf(gp(x_, noise_), y_, parallel=parallel)
    return np.asarray(jax.jit(f)(jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise)))


@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("name", list(KERNELS))
def test_logpdf_matches_jax(data, name, parallel):
    x, y = data
    kj = KERNELS[name]()
    want = _jax_logpdf(kj, x, y, parallel)
    fx = agt.GP(_port(kj))(_t(x), 0.1)
    got = tm.markov_logpdf(fx, _t(y), parallel=parallel)
    _close(got, want)
    # and the exact answer: the port's dense logpdf
    _close(got, _n(fx.logpdf(_t(y))), rtol=1e-8, atol_rel=1e-8)


def test_logpdf_unsorted_heteroscedastic_const_mean():
    rng = np.random.default_rng(3)
    n = 64
    x = rng.uniform(0.0, 5.0, size=n)  # deliberately unsorted
    y = rng.normal(size=n)
    noise = rng.uniform(0.05, 0.3, size=n)
    kj = agp.Matern32Kernel()
    fx = agt.GP(0.7, _port(kj))(_t(x), _t(noise))
    dense = _n(fx.logpdf(_t(y)))
    for parallel in (False, True):
        got = tm.markov_logpdf(fx, _t(y), parallel=parallel)
        _close(got, _jax_logpdf(kj, x, y, parallel, noise=noise, mean=0.7))
        _close(got, dense, rtol=1e-8, atol_rel=0.0)


@pytest.mark.parametrize("parallel", [False, True])
def test_logpdf_matrix_y(data, parallel):
    x, _ = data
    Y = np.random.default_rng(5).normal(size=(x.shape[0], 3))
    kj = agp.Matern32Kernel()
    fx = agt.GP(0.2, _port(kj))(_t(x), 0.1)
    got = tm.markov_logpdf(fx, _t(Y), parallel=parallel)
    assert got.shape == (3,)
    _close(got, _jax_logpdf(kj, x, Y, parallel, mean=0.2))
    _close(got, _n(fx.logpdf(_t(Y))), rtol=1e-8, atol_rel=1e-8)


@pytest.mark.parametrize("n", [250, 256, 333])
def test_chunked_scan_matches_jax(monkeypatch, n):
    """The chunked associative scan (n > _PAR_CHUNK, set to 64 in both
    packages) against the JAX package's, whose carries are a sequential
    fold, including a non-chunk-multiple n (zero padding) and six chunks
    with a ragged tail (333), and against the port's sequential filter:
    its logpdf and its filtered and predicted moments; and the gradient of
    a Matérn-3/2 logpdf in (σ², ℓ, noise) against the JAX package's."""
    monkeypatch.setattr(jm, "_PAR_CHUNK", 64)
    monkeypatch.setattr(tm, "_PAR_CHUNK", 64)
    rng = np.random.default_rng(n)
    x = np.sort(rng.uniform(0.0, 6.0, size=n))
    y = rng.normal(size=n)
    kj = agp.Matern32Kernel() + agp.Matern52Kernel()
    fx = agt.GP(_port(kj))(_t(x), 0.1)
    got = tm.markov_logpdf(fx, _t(y), parallel=True)
    _close(got, _jax_logpdf(kj, x, y, True))
    _close(got, _n(tm.markov_logpdf(fx, _t(y))), rtol=1e-8, atol_rel=0.0)
    A, Q, H, _ = tm._build_ssm(fx.f.kernel, _t(x), F64)
    r, obs = torch.full((n,), 0.1, dtype=F64), torch.ones(n, dtype=torch.bool)
    par = tm._par_filter(A, Q, H, _t(y), r, obs)
    for p_, s_ in zip(par, tm._seq_filter(A, Q, H, _t(y), r, obs)):
        _close(p_, s_, rtol=1e-8, atol_rel=1e-8)
    grad = _port_grad(x, y, True, _theta())
    want = _jax_grad(x, y, lambda fx, y_: jm.markov_logpdf(fx, y_, parallel=True))
    np.testing.assert_allclose(grad, want, rtol=1e-9, atol=1e-10)


def _fold_chunked_scan(combine, elems, identity, chunk):
    """The chunked scan with its cross-chunk carries folded left to right,
    one combine a chunk, as the JAX package composes them: the oracle of
    ``tm._chunked_associative_scan``'s scan over the chunk totals."""
    n = elems[0].shape[0]
    if n <= chunk:
        return tm._associative_scan(combine, elems)
    pad = (-n) % chunk
    nc = (n + pad) // chunk

    def pad_reshape(x):
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return x.reshape((nc, chunk) + tuple(x.shape[1:]))

    within = tm._associative_scan(combine, tuple(pad_reshape(x) for x in elems), axis=1)
    carry = tuple(torch.broadcast_to(i, w.shape[2:]) for i, w in zip(identity, within))
    carries = [carry]
    for c in range(nc - 1):
        carry = combine(carry, tuple(w[c, -1] for w in within))
        carries.append(carry)
    carries = tuple(torch.stack(cs)[:, None] for cs in zip(*carries))
    out = combine(carries, within)
    return tuple(o.reshape((-1,) + tuple(o.shape[2:]))[:n] for o in out)


def _filtering_elements(rng, n, D, batch):
    """n random well-posed filtering elements (A, b, C, η, J) of state
    dimension D, as ``_par_filter`` shapes them for a y of ``batch``
    columns: A contracting (spectral norm 0.9), C and J positive
    semi-definite, so every I + C·J the combine inverts is regular."""
    def psd():
        G = rng.normal(size=(n, 1, D, D)) / np.sqrt(D)
        return G @ np.swapaxes(G, -1, -2)

    M = rng.normal(size=(n, 1, D, D))
    A = 0.9 * M / np.linalg.norm(M, ord=2, axis=(-2, -1))[..., None, None]
    vec = lambda: rng.normal(size=(n, batch, D))  # noqa: E731
    return tuple(_t(e).requires_grad_() for e in (A, vec(), psd(), vec(), psd()))


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("nc", range(1, 41))
def test_the_scan_of_the_chunk_totals_matches_the_fold(nc, D):
    """The chunked scan, whose carries are an odd/even scan over the chunk
    totals, against the same scan with its carries folded chunk by chunk:
    1 to 40 chunks of 4 with a ragged tail, the real filtering-element
    combine, f64; the outputs and their gradients in every element tensor
    agree to rounding.

    The combine is associative where C and J are symmetric, as a filter's
    covariances and informations are, and each is a symmetric function of
    the hyperparameters. So the gradients in C and J are compared along
    symmetric directions, G + Gᵀ: their antisymmetric parts (a derivative
    off the monoid) depend on the association and differ by ~1e-4."""
    chunk = 4
    n = nc * chunk - nc % 3
    rng = np.random.default_rng(100 * D + nc)
    elems = _filtering_elements(rng, n, D, batch=2)
    eye = torch.eye(D, dtype=F64)
    combine = tm._element_combine(eye)
    zv, zm = torch.zeros(D, dtype=F64), torch.zeros(D, D, dtype=F64)
    identity = (eye, zv, zm, zv, zm)
    got = tm._chunked_associative_scan(combine, elems, identity, chunk=chunk)
    want = _fold_chunked_scan(combine, elems, identity, chunk)
    weights = [_t(rng.normal(size=w.shape)) for w in want]
    for g, w in zip(got, want):
        _close(g, _n(w))
    grads = [torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, weights)), elems)
             for out in (got, want)]
    for i, (g, w) in enumerate(zip(*grads)):
        if i in (2, 4):  # C, J
            g, w = g + g.mT, w + w.mT
        _close(g, w)


def test_associative_scan_matches_cumulative_sum():
    # the odd/even recursion at every length from 1 to 33, on a sum (exact
    # on integers) and on 2 × 2 matrix products (non-commutative)
    for n in range(1, 34):
        v = torch.arange(1, n + 1, dtype=F64)
        (s,) = tm._associative_scan(lambda a, b: (a[0] + b[0],), (v,))
        assert torch.equal(s, torch.cumsum(v, 0))
    mats = torch.as_tensor(np.random.default_rng(0).normal(size=(13, 2, 2)))
    (p,) = tm._associative_scan(lambda a, b: (b[0] @ a[0],), (mats,))
    want, acc = [], torch.eye(2, dtype=F64)
    for m in mats:
        acc = m @ acc
        want.append(acc)
    _close(p, torch.stack(want), atol_rel=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_stable_Q_matches_jax(p, dtype):
    lam, var = 1.7, 0.8
    # 2λ·dt from 0 (a repeated timepoint) and 1e-6 up to 30
    dts = np.concatenate([[0.0], np.logspace(-6, 1.5, 40)]) / (2 * lam)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jm._stable_Q(jnp.asarray(lam, jd), p, jnp.asarray(var, jd),
                                   jnp.asarray(dts, jd), jd))
    got = _n(tm._stable_Q(torch.tensor(lam, dtype=td), p, torch.tensor(var, dtype=td),
                          torch.as_tensor(dts.astype(dtype)), td))
    _, Pinf, _ = tm._component_matrices(torch.tensor(lam, dtype=F64), p,
                                        torch.tensor(var, dtype=F64), F64)
    d = np.sqrt(np.diag(_n(Pinf)))
    eps = np.finfo(dtype).eps
    tol = 64 * eps * (np.abs(want) + np.outer(d, d)[None])
    assert np.all(np.abs(got - want) <= tol), float(np.max(np.abs(got - want) / tol))
    assert np.all(got[0] == 0.0)  # dt = 0: no process noise


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_inv_posdef_small_matches_jax(D):
    rng = np.random.default_rng(D)
    X = rng.normal(size=(7, D, D + 2))
    M = X @ np.swapaxes(X, -1, -2) / (D + 2) + 0.3 * np.eye(D)
    want = np.asarray(jm._inv_posdef_small(jnp.asarray(M)))
    _close(tm._inv_posdef_small(_t(M)), want, atol_rel=1e-12)
    _close(tm._inv_posdef_small(_t(M)) @ _t(M), np.broadcast_to(np.eye(D), M.shape),
           rtol=0.0, atol_rel=1e-12)


@pytest.mark.parametrize("name", list(KERNELS) + ["nested"])
def test_sde_coefficients_match_jax(name):
    if name == "nested":
        kj = 0.5 * agp.with_lengthscale(
            1.5 * agp.with_lengthscale(agp.Matern52Kernel(), 0.5) + agp.ExponentialKernel(), 2.0)
    else:
        kj = KERNELS[name]()
    want = jm.sde_coefficients(kj)
    got = tm.sde_coefficients(_port(kj))
    assert [p for _, p, _ in got] == [p for _, p, _ in want]
    for (lg, _, vg), (lw, _, vw) in zip(got, want):
        _close(lg, np.asarray(lw), atol_rel=0.0)
        _close(vg, np.asarray(vw), atol_rel=0.0)


def test_sde_coefficients_keep_the_callers_graph():
    s2 = torch.tensor(1.3, dtype=F64, requires_grad=True)
    ell = torch.tensor(0.5, dtype=F64, requires_grad=True)
    ((lam, p, var),) = tm.sde_coefficients(s2 * agt.with_lengthscale(agt.Matern32Kernel(), ell))
    g_s2, g_ell = torch.autograd.grad(lam + var, (s2, ell))
    assert p == 2
    assert float(g_s2) == 1.0
    assert abs(float(g_ell) + np.sqrt(3.0) / 0.25) < 1e-12  # d(√3/ℓ)/dℓ


def test_unsupported_kernels_raise():
    assert not tm.is_markov_kernel(agt.SqExponentialKernel())
    assert not tm.is_markov_kernel(agt.Matern32Kernel() * agt.Matern52Kernel())
    assert not tm.is_markov_kernel(agt.with_lengthscale(agt.Matern32Kernel(), [0.5, 1.0]))
    assert tm.is_markov_kernel(2.0 * agt.with_lengthscale(agt.Matern52Kernel(), 0.3))
    with pytest.raises(TypeError, match="no exact 1-D state-space form"):
        tm.sde_coefficients(agt.PeriodicKernel())
    with pytest.raises(TypeError, match="only ScaleTransform"):
        tm.sde_coefficients(agt.with_lengthscale(agt.Matern32Kernel(), [0.5, 1.0]))
    x = torch.linspace(0, 1, 8, dtype=F64)
    with pytest.raises(TypeError):
        tm.markov_logpdf(agt.GP(agt.SqExponentialKernel())(x, 0.1), torch.zeros(8, dtype=F64))
    with pytest.raises(TypeError, match="1-D inputs"):
        tm.markov_logpdf(agt.GP(agt.Matern32Kernel())(torch.zeros((8, 2), dtype=F64), 0.1),
                         torch.zeros(8, dtype=F64))
    with pytest.raises(TypeError, match="diagonal-structured noise"):
        tm.markov_logpdf(agt.GP(agt.Matern32Kernel())(x, 0.1 * torch.eye(8, dtype=F64)),
                         torch.zeros(8, dtype=F64))
    with pytest.raises(TypeError, match="no state-space form"):
        agt.markov_posterior(agt.GP(agt.SqExponentialKernel())(x, 0.1), torch.zeros(8))


@pytest.mark.parametrize("parallel", [False, True])
def test_mean_and_var_match_jax(data, parallel):
    x, y = data
    xt = np.random.default_rng(7).uniform(-0.5, 6.5, size=40)
    kj = 1.4 * agp.with_lengthscale(agp.Matern52Kernel(), 0.7)
    want = jax.jit(lambda x_, y_, t_: jm.markov_mean_and_var(
        agp.GP(0.3, kj)(x_, 0.1), y_, t_, parallel=parallel))(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))
    fx = agt.GP(0.3, _port(kj))(_t(x), 0.1)
    mu, var = tm.markov_mean_and_var(fx, _t(y), _t(xt), parallel=parallel)
    _close(mu, np.asarray(want[0]))
    _close(var, np.asarray(want[1]))
    mu_d, var_d = agt.posterior(fx, _t(y)).mean_and_var(_t(xt))
    np.testing.assert_allclose(_n(mu), _n(mu_d), rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(_n(var), _n(var_d), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("parallel", [False, True])
def test_markov_posterior_matches_jax(parallel):
    rng = np.random.default_rng(11)
    x = np.sort(rng.uniform(size=23) * 4.0)
    z = rng.uniform(size=9) * 4.0
    y = rng.normal(size=23)
    kj = 0.7 * agp.with_lengthscale(agp.Matern52Kernel(), 1.1)

    @jax.jit
    def jax_side(x_, y_, z_):
        post = agp.markov_posterior(agp.GP(kj)(x_[:, None], 0.3), y_, parallel=parallel)
        return (*post.mean_and_cov(z_[:, None]), post.cov(z_[:, None], x_[:, None]))

    m_j, C_j, Czx_j = (np.asarray(a) for a in jax_side(jnp.asarray(x), jnp.asarray(y),
                                                       jnp.asarray(z)))
    post = agt.markov_posterior(agt.GP(_port(kj))(_t(x)[:, None], 0.3), _t(y), parallel=parallel)
    assert isinstance(post, agt.MarkovPosteriorGP)
    zt, xt_ = _t(z)[:, None], _t(x)[:, None]
    m, C = post.mean_and_cov(zt)
    _close(m, m_j)
    _close(C, C_j)
    _close(post.cov(zt, xt_), Czx_j)
    # the other surfaces against the same JAX outputs (the JAX package's own
    # tests hold mean/var/cov(z) equal to mean_and_cov's)
    _close(post.mean(zt), m_j)
    _close(post.var(zt), np.diagonal(C_j))
    _close(post.cov(zt), C_j)


def test_posterior_cov_scales_past_training_size():
    # cov between M query points is O(M²): at N = 5000 training points the
    # (M, M) table's diagonal matches the O(N) marginal path
    rng = np.random.default_rng(1)
    n, m = 5000, 12
    x = np.sort(rng.uniform(size=n) * 100.0)
    y = np.sin(x) + 0.1 * rng.normal(size=n)
    f = agt.GP(agt.with_lengthscale(agt.Matern32Kernel(), 2.0))
    post = agt.markov_posterior(f(_t(x)[:, None], 0.01), _t(y), parallel=True)
    z = torch.linspace(0.0, 100.0, m, dtype=F64)[:, None]
    mu, C = post.mean_and_cov(z)
    assert C.shape == (m, m) and bool(torch.isfinite(C).all())
    _, v = post.mean_and_var(z)
    np.testing.assert_allclose(_n(torch.diagonal(C)), _n(v), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("parallel", [False, True])
def test_posterior_empty_query(parallel):
    rng = np.random.default_rng(2)
    x = np.sort(rng.uniform(size=12) * 3.0)[:, None]
    post = agt.markov_posterior(agt.GP(agt.Matern32Kernel())(_t(x), 0.1),
                                _t(rng.normal(size=12)), parallel=parallel)
    mu, C = post.mean_and_cov(torch.zeros((0, 1), dtype=F64))
    assert mu.shape == (0,) and C.shape == (0, 0)


@pytest.mark.parametrize("parallel", [False, True])
def test_rand_replays_jax_draws(data, parallel):
    """FFBS with the JAX package's ε (``jax.random.normal(key, (n_all, S,
    D))``, ``models/markov.py:649``) replayed through a draws object: the
    same samples."""
    x, y = data
    xt = np.sort(np.random.default_rng(9).uniform(0.5, 5.5, size=10))
    kj = 1.2 * agp.with_lengthscale(agp.Matern32Kernel(), 0.8)
    key, S, D = jax.random.PRNGKey(0), 5, 2
    want = jax.jit(lambda x_, y_, t_, k_: jm.markov_rand(
        agp.GP(kj)(x_, 0.1), y_, t_, k_, S, parallel=parallel))(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt), key)
    eps = np.asarray(jax.random.normal(key, (x.size + xt.size, S, D), jnp.float64))
    fx = agt.GP(_port(kj))(_t(x), 0.1)
    got = tm.markov_rand(fx, _t(y), _t(xt), JaxDraws([("normal", eps)]), S, parallel=parallel)
    assert got.shape == (10, S)
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=0.0, atol=1e-8)
    post = agt.markov_posterior(fx, _t(y), parallel=parallel)
    again = post.rand(JaxDraws([("normal", eps)]), _t(xt), num_samples=S)
    assert torch.equal(again, got)


def test_rand_single_sample_shape(data):
    x, y = data
    fx = agt.GP(agt.Matern52Kernel())(_t(x), 0.1)
    s = tm.markov_rand(fx, _t(y), torch.linspace(0, 6, 17, dtype=F64), 1)
    assert s.shape == (17,) and bool(torch.isfinite(s).all())
    gen = torch.Generator().manual_seed(1)
    s2 = tm.markov_rand(fx, _t(y), torch.linspace(0, 6, 17, dtype=F64), gen)
    assert torch.equal(s, s2)  # an int seed is a generator seeded with it


@pytest.mark.parametrize("parallel", [False, True])
def test_rand_moments_match_dense_posterior(data, parallel):
    # the statistical oracle of the JAX tests: 6000 draws of the port's own
    # generator, empirical mean and covariance against the dense posterior
    x, y = data
    kern = 1.2 * agt.with_lengthscale(agt.Matern32Kernel(), 0.8)
    fx = agt.GP(kern)(_t(x), 0.1)
    xt = _t(np.sort(np.random.default_rng(4).uniform(0.5, 5.5, size=10)))
    S = _n(tm.markov_rand(fx, _t(y), xt, torch.Generator().manual_seed(0), 6000,
                          parallel=parallel))
    assert S.shape == (10, 6000)
    post = agt.posterior(fx, _t(y))
    mu_d, cov_d = _n(post.mean(xt)), _n(post.cov(xt))
    np.testing.assert_allclose(S.mean(1), mu_d, atol=4.5 * np.sqrt(
        np.diagonal(cov_d).max() / 6000) + 1e-3)
    np.testing.assert_allclose(np.cov(S), cov_d, atol=0.05 * cov_d.max() + 5e-3)


def _theta(s2=1.2, ell=0.6, noise=0.15):
    return {k: torch.tensor(v, dtype=F64, requires_grad=True)
            for k, v in (("s2", s2), ("ell", ell), ("noise", noise))}


def _port_grad(x, y, parallel, theta):
    k = theta["s2"] * agt.with_lengthscale(agt.Matern32Kernel(), theta["ell"])
    lp = tm.markov_logpdf(agt.GP(k)(_t(x), theta["noise"]), _t(y), parallel=parallel)
    return [float(g) for g in torch.autograd.grad(-lp, list(theta.values()))]


def _jax_grad(x, y, logpdf):
    def nlml(p):
        k = p["s2"] * agp.with_lengthscale(agp.Matern32Kernel(), p["ell"])
        return -logpdf(agp.GP(k)(jnp.asarray(x), p["noise"]), jnp.asarray(y))

    p = {"s2": jnp.float64(1.2), "ell": jnp.float64(0.6), "noise": jnp.float64(0.15)}
    g = jax.jit(jax.grad(nlml))(p)
    return [float(g[k]) for k in ("s2", "ell", "noise")]


@pytest.mark.parametrize("parallel", [False, True])
def test_gradients_match_jax(data, parallel):
    x, y = data
    got = _port_grad(x, y, parallel, _theta())
    want = _jax_grad(x, y, lambda fx, y_: jm.markov_logpdf(fx, y_, parallel=parallel))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)
    dense = _jax_grad(x, y, lambda fx, y_: fx.logpdf(y_))
    np.testing.assert_allclose(got, dense, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("parallel", [False, True])
def test_gradients_at_a_repeated_timepoint_match_dense(parallel):
    """With t[10] = t[11] (dt = 0), the JAX package's Markov ∇ in the
    lengthscale is NaN: the derivative of ``gammainc(1, x)`` at x = 0 is
    0·log 0. The port writes P(1, x) as ``−expm1(−x)`` (a deliberate
    divergence), so its ∇ is finite and matches the JAX package's dense
    ``fx.logpdf`` ∇ in every component."""
    rng = np.random.default_rng(40)
    x = np.sort(rng.uniform(0.0, 6.0, size=40))
    x[11] = x[10]
    y = rng.normal(size=40)
    got = _port_grad(x, y, parallel, _theta())
    assert np.all(np.isfinite(got))
    want = _jax_grad(x, y, lambda fx, y_: fx.logpdf(y_))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("parallel", [False, True])
def test_f32_accuracy_dense_sampling(parallel):
    """The f32 filters in the small-λdt regime (n = 4000 over 60
    lengthscales) stay inside the JAX package's f32 contract of 1e-3
    relative to the port's f64."""
    rng = np.random.default_rng(8)
    n = 4000
    x = np.sort(rng.uniform(0.0, 30.0, size=n))
    y = rng.normal(size=n)
    for kern in (1.0 * agt.with_lengthscale(agt.Matern32Kernel(), 0.5),
                 0.8 * agt.with_lengthscale(agt.Matern52Kernel(), 0.4)):
        want = float(tm.markov_logpdf(agt.GP(kern)(_t(x), 0.1), _t(y), parallel=True).detach())
        fx32 = agt.GP(kern)(_t(x, torch.float32), 0.1)
        got = tm.markov_logpdf(fx32, _t(y, torch.float32), parallel=parallel)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) / abs(want) < 1e-3, (kern, parallel, float(got), want)


def test_parallel_filter_at_2000_points_is_finite_and_matches_sequential():
    rng = np.random.default_rng(6)
    x = np.sort(rng.uniform(0, 50.0, size=2000))
    fx = agt.GP(agt.Matern52Kernel())(_t(x), 0.1)
    y = _t(rng.normal(size=2000))
    par = tm.markov_logpdf(fx, y, parallel=True)
    assert bool(torch.isfinite(par))
    _close(par, _n(tm.markov_logpdf(fx, y)), rtol=1e-8, atol_rel=0.0)
