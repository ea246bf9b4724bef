"""The port's distributions, ``FiniteGP.to_mvnormal``, ``LatentGP``, the
elliptical-slice and SMC samplers and the MCMC diagnostics, against the
JAX package.

- Every distribution's ``logpdf`` against the JAX package's at f64 on the
  same numpy inputs, to 1e-12 relative; samples have the broadcast shape,
  the parameters' dtype and device, and the right first moments.
- ``to_mvnormal``: (m, L) and its logpdf against ``FiniteGP``'s.
- ``LatentFiniteGP.logpdf`` under Poisson and Normal likelihoods, with its
  gradient in f, against ``jax.grad`` of the JAX package (f64, 1e-10), and
  the Gaussian-consistency case of tests/test_latent_gp.py:33.
- ESS and SMC against the JAX package at f64: draws objects replay the
  JAX package's key splits (``JaxEssDraws``, ``JaxSmcDraws``), so
  ``systematic_resample`` gives the same ancestors, one ``ess_kernel``
  transition a chain and a whole ``run_ess`` give the same states and
  shrink counts, and ``run_smc`` stopped after each of its stages gives
  the same particles, log evidence and acceptance (1e-10): the tempering
  schedule, the resampling and the rejuvenation, stage by stage.
- ESS and SMC moments on the conjugate Gaussians of
  tests/test_ess_smc.py, cut to size; ESS on a LatentGP Poisson model;
  systematic resampling's frequencies.
- ``rhat`` and ``ess`` equal the JAX package's on the same numpy draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
from torch_port_helpers import kernel_tree

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu import distributions as jd
from abstractgps_tpu.inference.mcmc import diagnostics as jdiag
from abstractgps_tpu.inference.mcmc import ess as jess
from abstractgps_tpu.inference.mcmc import smc as jsmc
from abstractgps_tpu_torch import distributions as td
from abstractgps_tpu_torch.inference.mcmc import diagnostics as tdiag
from abstractgps_tpu_torch.inference.mcmc import (
    ess_init,
    ess_kernel,
    run_ess,
    run_smc,
    systematic_resample,
)
from abstractgps_tpu_torch.inference.mcmc.sample import chain_values
from abstractgps_tpu_torch.ops import distance

F64 = torch.float64


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


def _n(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------


def _dist_cases(rng):
    """(name, numpy parameters, numpy y) for every scalar family."""
    y_pos = rng.uniform(0.2, 3.0, size=7)
    return [
        ("Normal", (rng.normal(size=7), rng.uniform(0.5, 2.0, size=7)), rng.normal(size=7)),
        ("Poisson", (rng.uniform(0.5, 4.0, size=7),),
         np.array([0.0, 1.0, 3.0, 2.5, 7.0, 0.3, 4.0])),  # non-integer y too
        ("Bernoulli", (rng.normal(size=7),), np.array([0.0, 1.0, 1.0, 0.0, 1.0, 0.0, 1.0])),
        ("Exponential", (rng.uniform(0.5, 2.0, size=7),), y_pos),
        ("Gamma", (rng.uniform(0.5, 3.0, size=7), rng.uniform(0.5, 2.0, size=7)), y_pos),
        ("LogNormal", (rng.normal(size=7), rng.uniform(0.5, 1.5, size=7)), y_pos),
    ]


def test_distribution_logpdfs_match_jax():
    rng = np.random.default_rng(0)
    for name, params, y in _dist_cases(rng):
        want = np.asarray(getattr(jd, name)(*map(jnp.asarray, params)).logpdf(jnp.asarray(y)))
        got = getattr(td, name)(*map(_t, params)).logpdf(_t(y))
        np.testing.assert_allclose(_n(got), want, rtol=1e-12, atol=1e-12, err_msg=name)
        # the product distribution sums them
        jp = jd.product_distribution(getattr(jd, name)(*map(jnp.asarray, params)))
        tp = td.product_distribution(getattr(td, name)(*map(_t, params)))
        np.testing.assert_allclose(float(tp.logpdf(_t(y))), float(jp.logpdf(jnp.asarray(y))),
                                   rtol=1e-12)
    # Python-number parameters are float64, as under the JAX package's x64
    np.testing.assert_allclose(float(td.Normal(0.3, 1.2).logpdf(_t(0.7))),
                               scipy.stats.norm(0.3, 1.2).logpdf(0.7), rtol=1e-12)


def test_mvnormal_matches_jax():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(6, 9))
    L = np.linalg.cholesky(X @ X.T / 9 + 0.3 * np.eye(6))
    m = rng.normal(size=6)
    Y = rng.normal(size=(6, 3))
    jm, tm = jd.MvNormal(jnp.asarray(m), jnp.asarray(L)), td.MvNormal(_t(m), _t(L))
    for y in (Y[:, 0], Y):
        np.testing.assert_allclose(_n(tm.logpdf(_t(y))), np.asarray(jm.logpdf(jnp.asarray(y))),
                                   rtol=1e-12)
    g = torch.Generator().manual_seed(0)
    s = tm.sample(g, num_samples=4000)
    assert s.shape == (6, 4000) and tm.sample(g).shape == (6,)
    np.testing.assert_allclose(_n(s).mean(1), m, atol=0.1)
    np.testing.assert_allclose(np.cov(_n(s)), L @ L.T, atol=0.1)


def test_distribution_samples():
    g = torch.Generator().manual_seed(1)
    n = 20000
    cases = [
        (td.Normal(torch.full((n,), 0.5, dtype=torch.float32), 2.0), 0.5),
        (td.Poisson(torch.full((n,), 3.0, dtype=F64)), 3.0),
        (td.Bernoulli(torch.full((n,), 0.4, dtype=F64)), 1.0 / (1.0 + np.exp(-0.4))),
        (td.Exponential(torch.full((n,), 2.0, dtype=F64)), 0.5),
        (td.Gamma(torch.tensor(2.5, dtype=F64), torch.full((n,), 1.5, dtype=F64)), 2.5 / 1.5),
        (td.Gamma(torch.full((n,), 0.4, dtype=F64), 2.0), 0.2),
        (td.LogNormal(torch.full((n,), 0.1, dtype=F64), 0.3), np.exp(0.1 + 0.045)),
    ]
    for dist, mean in cases:
        s = dist.sample(g)
        assert s.shape == (n,) and s.is_floating_point(), type(dist).__name__
        assert torch.isfinite(s).all()
        np.testing.assert_allclose(float(s.double().mean()), mean, rtol=0.03,
                                   err_msg=type(dist).__name__)
    assert cases[0][0].sample(g).dtype == torch.float32
    # a scalar concentration with a vector rate gives independent draws
    gs = td.Gamma(2.0, torch.full((n,), 1.0, dtype=F64)).sample(g)
    assert float(gs.std()) > 1.0


# ---------------------------------------------------------------------------
# to_mvnormal and LatentGP
# ---------------------------------------------------------------------------


def _gp_pair(kj):
    return kj, agt.kernel_from_numpy(kernel_tree(kj))


def test_to_mvnormal_matches_finite_gp():
    rng = np.random.default_rng(2)
    x, y = rng.uniform(size=(20, 2)), rng.normal(size=20)
    kj, kt = _gp_pair(1.3 * agp.with_lengthscale(agp.Matern32Kernel(), 0.6))
    fj, ft = agp.GP(0.4, kj)(jnp.asarray(x), 0.05), agt.GP(0.4, kt)(_t(x), 0.05)
    dj, dt = fj.to_mvnormal(), ft.to_mvnormal()
    assert isinstance(dt, td.MvNormal)
    np.testing.assert_allclose(_n(dt.loc), np.asarray(dj.loc), rtol=1e-12)
    np.testing.assert_allclose(_n(dt.scale_tril), np.asarray(dj.scale_tril), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(float(dt.logpdf(_t(y)).detach()), float(ft.logpdf(_t(y)).detach()),
                               rtol=1e-12)
    np.testing.assert_allclose(float(dt.logpdf(_t(y)).detach()), float(fj.logpdf(jnp.asarray(y))),
                               rtol=1e-12)


@pytest.mark.parametrize("lik", ["poisson", "normal"])
def test_latent_logpdf_and_grad_match_jax(lik):
    rng = np.random.default_rng(3)
    x = rng.normal(size=8)
    fv = rng.normal(size=8)
    if lik == "poisson":
        y = rng.poisson(2.0, size=8).astype(float)
        jlik, tlik = (lambda f: jd.Poisson(jnp.exp(f))), (lambda f: td.Poisson(torch.exp(f)))
    else:
        y = rng.normal(size=8)
        jlik, tlik = (lambda f: jd.Normal(f, 0.3)), (lambda f: td.Normal(f, 0.3))
    kj, kt = _gp_pair(agp.Matern52Kernel())
    jl = agp.LatentGP(agp.GP(kj), jlik, 1e-8)(jnp.asarray(x))
    tl = agt.LatentGP(agt.GP(kt), tlik, 1e-8)(_t(x))
    assert len(tl) == 8

    def jjoint(f):
        return jl.logpdf({"f": f, "y": jnp.asarray(y)})

    f_t = _t(fv).requires_grad_()
    lp = tl.logpdf({"f": f_t, "y": _t(y)})
    (g,) = torch.autograd.grad(lp, f_t)
    np.testing.assert_allclose(float(lp.detach()), float(jjoint(jnp.asarray(fv))), rtol=1e-10)
    np.testing.assert_allclose(_n(g), np.asarray(jax.grad(jjoint)(jnp.asarray(fv))), rtol=1e-10,
                               atol=1e-10)
    # the joint is the projection's logpdf plus the likelihood's
    want = tl.fx.logpdf(_t(fv)) + torch.sum(tlik(_t(fv)).logpdf(_t(y)))
    np.testing.assert_allclose(float(lp.detach()), float(want.detach()), rtol=1e-12)


def test_latent_gp_gaussian_consistency():
    # tests/test_latent_gp.py:33: with a Gaussian likelihood the joint is
    # the latent logpdf plus scipy's normal logpdf of the observations
    rng = np.random.default_rng(42)
    x, fv, yv = rng.standard_normal(8), rng.standard_normal(8), rng.standard_normal(8)
    lfx = agt.LatentGP(agt.GP(agt.SqExponentialKernel()), lambda f: td.Normal(f, 0.3),
                       1e-10)(_t(x))
    lp = lfx.logpdf({"f": _t(fv), "y": _t(yv)})
    ref = float(lfx.fx.logpdf(_t(fv)).detach()) + np.sum(scipy.stats.norm(fv, 0.3).logpdf(yv))
    np.testing.assert_allclose(float(lp.detach()), ref, rtol=1e-10)


def test_latent_rand():
    x = torch.linspace(0.0, 5.0, 15, dtype=F64)
    lfx = agt.LatentGP(agt.GP(agt.Matern32Kernel()), lambda f: td.Poisson(torch.exp(f)),
                       1e-8)(x)
    s = lfx.rand(torch.Generator().manual_seed(0))
    assert s["f"].shape == (15,) and s["y"].shape == (15,)
    assert (s["y"] >= 0).all() and torch.equal(s["y"], torch.round(s["y"]))
    assert torch.isfinite(lfx.logpdf(s))


# ---------------------------------------------------------------------------
# ESS and SMC (tests/test_ess_smc.py, cut to size)
# ---------------------------------------------------------------------------


class JaxEssDraws:
    """The draw sites of ``ess_kernel`` fed from the JAX package's key
    splits: ``run_ess``'s split a step (``ess.py:135``), the step key's
    three (``:48``) and the shrink loop's split of the step key (``:84``),
    one key a chain. ``sample_prior`` is the JAX side of the prior draw. A
    chain that is not looking draws nothing, as its masked ``while_loop``
    carry would not."""

    def __init__(self, keys, sample_prior):
        self.keys, self.sample_prior = list(keys), sample_prior
        self.loop, self.k_u, self.k_theta = ([None] * len(self.keys) for _ in range(3))

    def prior(self, sample_prior, q):
        out = []
        for c in range(len(self.keys)):
            self.keys[c], ks = jax.random.split(self.keys[c])
            k_nu, self.k_u[c], self.k_theta[c] = jax.random.split(ks, 3)
            self.loop[c] = ks
            out.append(np.asarray(self.sample_prior(k_nu)))
        return _t(np.stack(out))

    def level_uniform(self, q):
        return _t([jax.random.uniform(k, (), jnp.float64) for k in self.k_u])

    def angle_uniform(self, q):
        return _t([jax.random.uniform(k, (), jnp.float64) for k in self.k_theta])

    def shrink_uniform(self, q, active):
        out = []
        for c, on in enumerate(active.tolist()):
            if on:
                self.loop[c], k = jax.random.split(self.loop[c])
            out.append(float(jax.random.uniform(k, (), jnp.float64)) if on else 0.5)
        return _t(out)


class JaxSmcDraws:
    """The draw sites of ``run_smc`` fed from the JAX package's key splits:
    three a stage (``smc.py:151``), ``num_moves`` of the move key
    (``:141``) and two a move (``:126``)."""

    def __init__(self, key, num_moves):
        self.key, self.num_moves, self.moves, self.k_acc = key, num_moves, [], None

    def resample_uniform(self, w):
        self.key, k_rs, k_mv = jax.random.split(self.key, 3)
        self.moves = list(jax.random.split(k_mv, self.num_moves))
        return _t(jax.random.uniform(k_rs, (), jnp.float64))

    def proposal_normal(self, particles):
        k_prop, self.k_acc = jax.random.split(self.moves.pop(0))
        return _t(jax.random.normal(k_prop, tuple(particles.shape), jnp.float64))

    def move_uniform(self, particles):
        return _t(jax.random.uniform(self.k_acc, (particles.shape[0],), jnp.float64))


class _KeyUniform:
    """``systematic_resample``'s one draw from a JAX key (``smc.py:41``)."""

    def __init__(self, key):
        self.key = key

    def resample_uniform(self, w):
        return _t(jax.random.uniform(self.key, (), jnp.float64))


def _conjugate(dim, s2, seed):
    """Prior N(0, K) on a 1-D SE gram, likelihood N(y | q, s2·I): the JAX
    and port log likelihoods and prior draws on the same numpy values."""
    K = _n(agt.kernelmatrix(agt.SEKernel(), torch.linspace(0, 2, dim, dtype=F64)).detach())
    L = np.linalg.cholesky(K + 1e-8 * np.eye(dim))
    y = np.random.default_rng(seed).normal(size=dim)
    Lt, yt, Lj, yj = _t(L), _t(y), jnp.asarray(L), jnp.asarray(y)
    return dict(
        K=K, y=y,
        tll=lambda q: -0.5 * torch.sum((q - yt) ** 2) / s2,
        jll=lambda q: -0.5 * jnp.sum((q - yj) ** 2) / s2,
        tprior=lambda g: Lt @ torch.randn(dim, generator=g, dtype=F64),
        jprior=lambda k: Lj @ jax.random.normal(k, (dim,), jnp.float64),
    )


def test_systematic_resample_matches_jax():
    rng = np.random.default_rng(11)
    for seed in range(4):
        log_w = rng.normal(scale=2.0, size=50)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jsmc.systematic_resample(key, jnp.asarray(log_w)))
        got = _n(systematic_resample(_KeyUniform(key), _t(log_w)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chain_eval,max_shrink", [("vmap", 64), ("loop", 64), ("vmap", 2)])
def test_ess_transition_matches_jax(chain_eval, max_shrink):
    # a sharp likelihood, so the angle bracket shrinks several times and
    # chains stop after different counts (max_shrink=2: some give up)
    dim, chains = 5, 6
    m = _conjugate(dim, 0.02, 12)
    q0 = np.random.default_rng(13).normal(size=(chains, dim))
    keys = list(jax.random.split(jax.random.PRNGKey(14), chains))
    jstep = jess.ess_kernel(m["jll"], m["jprior"], max_shrink=max_shrink)
    want = [jstep(jax.random.split(keys[c])[1], jess.ess_init(m["jll"], jnp.asarray(q0[c])))
            for c in range(chains)]
    values = chain_values(m["tll"], chain_eval)
    state, count = ess_kernel(values, m["tprior"], max_shrink=max_shrink)(
        JaxEssDraws(keys, m["jprior"]), ess_init(values, _t(q0)))
    np.testing.assert_array_equal(_n(count), [int(n) for _, n in want])
    np.testing.assert_allclose(_n(state.q), np.stack([np.asarray(s.q) for s, _ in want]),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_n(state.loglik), [float(s.loglik) for s, _ in want],
                               rtol=1e-10, atol=1e-10)
    assert len(set(_n(count).tolist())) > 1  # the masks were exercised
    if max_shrink == 2:
        stuck = _n(count) == 2
        assert stuck.any()
    else:
        assert (_n(count) < max_shrink).all()


def test_run_ess_matches_jax():
    dim, chains = 4, 3
    m = _conjugate(dim, 0.3, 15)
    key = jax.random.PRNGKey(16)
    want_q, want_ll = jess.run_ess(m["jll"], m["jprior"], jnp.zeros(dim), key, num_samples=12,
                                   num_burnin=4, num_chains=chains)
    got_q, got_ll = run_ess(m["tll"], m["tprior"], torch.zeros(dim, dtype=F64),
                            JaxEssDraws(jax.random.split(key, chains), m["jprior"]),
                            num_samples=12, num_burnin=4, num_chains=chains)
    assert got_q.shape == want_q.shape == (chains, 12, dim)
    np.testing.assert_allclose(_n(got_q), np.asarray(want_q), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_n(got_ll), np.asarray(want_ll), rtol=1e-10, atol=1e-10)


def test_run_smc_matches_jax():
    # stopped after each stage in turn, so every stage's tempering step,
    # resampling and rejuvenation are held, not only the end
    dim, s2, n, moves = 3, 0.2, 128, 3
    y = np.random.default_rng(17).normal(size=dim)
    yt, yj = _t(y), jnp.asarray(y)
    p0 = np.random.default_rng(18).normal(size=(n, dim))
    key = jax.random.PRNGKey(19)

    def jprior(q):
        return -0.5 * jnp.sum(q * q)

    def jlik(q):
        return -0.5 * jnp.sum((q - yj) ** 2) / s2

    def tprior(q):
        return -0.5 * torch.sum(q * q)

    def tlik(q):
        return -0.5 * torch.sum((q - yt) ** 2) / s2

    full = jsmc.run_smc(jprior, jlik, jnp.asarray(p0), key, num_moves=moves)
    stages = int(full.num_stages)
    assert stages >= 3
    for k in range(1, stages + 1):
        want = full if k == stages else jsmc.run_smc(jprior, jlik, jnp.asarray(p0), key,
                                                     num_moves=moves, max_stages=k)
        got = run_smc(tprior, tlik, _t(p0), JaxSmcDraws(key, moves), num_moves=moves,
                      max_stages=k)
        assert got.num_stages == int(want.num_stages) == k
        np.testing.assert_allclose(_n(got.particles), np.asarray(want.particles), rtol=1e-10,
                                   atol=1e-10, err_msg=f"stage {k}")
        np.testing.assert_allclose(float(got.log_evidence), float(want.log_evidence),
                                   rtol=1e-10, atol=1e-10, err_msg=f"stage {k}")
        np.testing.assert_allclose(float(got.acceptance), float(want.acceptance), rtol=1e-12,
                                   err_msg=f"stage {k}")


def test_systematic_resample_unbiased():
    log_w = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=F64))
    g = torch.Generator().manual_seed(0)
    counts = np.zeros(4)
    for _ in range(200):
        counts += np.bincount(_n(systematic_resample(g, log_w)), minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), [0.1, 0.2, 0.3, 0.4], atol=0.02)


def test_ess_conjugate_gaussian():
    # prior N(0, K), likelihood y ~ N(q, s2 I) → posterior analytic
    dim, s2 = 5, 0.3
    K = _n(agt.kernelmatrix(agt.SEKernel(), torch.linspace(0, 2, dim, dtype=F64)).detach())
    K = K + 1e-8 * np.eye(dim)
    L = torch.as_tensor(np.linalg.cholesky(K))
    y = torch.as_tensor(np.random.default_rng(4).normal(size=dim))

    def loglik(q):
        return -0.5 * torch.sum((q - y) ** 2) / s2

    def sample_prior(g):
        return L @ torch.randn(dim, generator=g, dtype=F64)

    qs, lls = run_ess(loglik, sample_prior, torch.zeros(dim, dtype=F64), 5, num_samples=1500,
                      num_burnin=200, num_chains=4)
    assert qs.shape == (4, 1500, dim) and lls.shape == (4, 1500)
    qs = _n(qs).reshape(-1, dim)
    post_cov = np.linalg.inv(np.linalg.inv(K) + np.eye(dim) / s2)
    post_mean = post_cov @ (_n(y) / s2)
    np.testing.assert_allclose(qs.mean(0), post_mean, atol=0.1)
    np.testing.assert_allclose(np.cov(qs.T), post_cov, atol=0.1)


def test_ess_latent_gp_poisson():
    # the LatentGP-Poisson workflow: latents u ~ N(0, K) under Poisson(exp(u))
    x = torch.linspace(0.0, 3.0, 12, dtype=F64)
    lgp = agt.LatentGP(agt.GP(agt.with_lengthscale(agt.SEKernel(), 1.0)),
                       lambda f: td.Poisson(torch.exp(f)), 1e-8)
    lfx = lgp(x)
    truth = lfx.rand(torch.Generator().manual_seed(6))
    prior = lfx.fx.to_mvnormal()

    def loglik(u):
        return lfx.lik(u).logpdf(truth["y"]).sum()

    for mode in ("vmap", "loop"):
        qs, lls = run_ess(loglik, prior.sample, torch.zeros(12, dtype=F64), 7,
                          num_samples=500, num_burnin=100, num_chains=2, chain_eval=mode)
        assert np.isfinite(_n(lls)).all()
        corr = np.corrcoef(_n(qs).reshape(-1, 12).mean(0), _n(truth["f"]))[0, 1]
        assert corr > 0.5, mode


def test_smc_conjugate_gaussian():
    # prior N(0, I), lik N(y|q, s2 I): posterior and evidence analytic
    dim, s2 = 3, 0.5
    y = torch.as_tensor(np.random.default_rng(8).normal(size=dim))

    def logprior(q):
        return -0.5 * torch.sum(q * q) - 0.5 * dim * np.log(2 * np.pi)

    def loglik(q):
        return -0.5 * torch.sum((q - y) ** 2) / s2 - 0.5 * dim * np.log(2 * np.pi * s2)

    g = torch.Generator().manual_seed(9)
    particles0 = torch.randn((2048, dim), generator=g, dtype=F64)
    res = run_smc(logprior, loglik, particles0, g)
    post_var = 1.0 / (1.0 + 1.0 / s2)
    qs = _n(res.particles)
    np.testing.assert_allclose(qs.mean(0), post_var * _n(y) / s2, atol=0.08)
    np.testing.assert_allclose(qs.var(0), post_var * np.ones(dim), atol=0.08)
    log_z = float(-0.5 * np.sum(_n(y) ** 2) / (1 + s2) - 0.5 * dim * np.log(2 * np.pi * (1 + s2)))
    np.testing.assert_allclose(float(res.log_evidence), log_z, atol=0.15)
    assert res.num_stages >= 2 and 0.0 < float(res.acceptance) <= 1.0


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


def test_diagnostics_match_jax():
    rng = np.random.default_rng(10)
    # AR(1) chains, one with a shifted mean, so R̂ and ESS are nontrivial
    x = np.zeros((4, 300))
    for t in range(1, 300):
        x[:, t] = 0.8 * x[:, t - 1] + rng.normal(size=4)
    x[3] += 0.5
    assert tdiag.rhat(torch.as_tensor(x)) == jdiag.rhat(x)
    assert tdiag.ess(x) == jdiag.ess(x)
    tree = {"a": x[:, :, None] * np.ones(2), "b": [x]}
    tr, jr = tdiag.rhat_tree(tree), jdiag.rhat_tree(tree)
    np.testing.assert_array_equal(tr["a"], jr["a"])
    assert tdiag.ess_tree(tree)["b"][0] == jdiag.ess_tree(tree)["b"][0]
