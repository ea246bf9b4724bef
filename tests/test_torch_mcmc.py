"""The port's MCMC layer (``abstractgps_tpu_torch.inference.mcmc``) and its
``set_enabled`` switch, against the JAX package.

- Adaptation (dual averaging, Welford, Stan's window schedule): the same
  sequences through both packages, equal.
- ``leapfrog`` and single NUTS and HMC transitions at f64: the port's
  batched transition is driven by a draws object that replays the JAX
  package's key splits chain by chain (``JaxNutsDraws``, ``JaxHmcDraws``),
  so each chain's transition is held against ``nuts_kernel`` /
  ``hmc_kernel`` of the JAX package under that chain's key: the same
  num_steps, depth and diverging flags, q, logdens and accept_prob within
  1e-10. Chains take different step sizes, so they stop at different
  depths and leaves and the masks are exercised.
- The GP hyperparameter density at N = 1024 on the kernel path (interpret
  mode: the kernels' plain versions, f32). Its gates need f32, where the
  two packages' densities differ by f32 rounding, so both samplers are
  given the same density, the port's kernel path (f32, cast to f64; the
  JAX sampler reads it through ``jax.pure_callback``): the comparison
  isolates the samplers, at f64, with ``chain_eval="loop"``. The density
  itself is held against the JAX package's in tests/test_torch_grad.py.
- ``chain_eval``: "vmap" and "loop" give the same draws; "vmap" on the
  fused density raises, naming "loop".
- Moments of NUTS and HMC on analytic targets (tests/test_mcmc.py, cut).
- ``set_enabled(False)``: every gate is closed, and the logpdf and its
  gradient equal the library path's, with no kernel wrapper called.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import small_kernel_paths

import abstractgps_tpu_torch as agt
from abstractgps_tpu.inference.mcmc import adaptation as jad
from abstractgps_tpu.inference.mcmc import hmc as jhmc
from abstractgps_tpu.inference.mcmc import nuts as jnuts
from abstractgps_tpu_torch.inference.mcmc import adaptation as tad
from abstractgps_tpu_torch.inference.mcmc import (
    HMCState,
    hmc_kernel,
    init_chain_positions,
    leapfrog,
    logdensity_and_grad,
    nuts_kernel,
    run_mcmc,
)
from abstractgps_tpu_torch.inference.mcmc.hmc import IntegratorState
from abstractgps_tpu_torch.ops import blocked_chol, covmat, cuda, distance, fused_gram

F64 = torch.float64


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


def _n(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# The JAX package's key splits, replayed chain by chain
# ---------------------------------------------------------------------------


class JaxNutsDraws:
    """The draw sites of ``nuts_kernel`` fed from the JAX package's key
    splits (``nuts.py:230-231, 269-270, 168-177, 282``), one key a chain; a
    chain that is not active draws nothing, as its masked ``while_loop``
    carry would not."""

    def __init__(self, keys):
        self.keys = list(keys)
        self.sub = [None] * len(self.keys)
        self.bias = [None] * len(self.keys)

    def momentum(self, q):
        out = []
        for c in range(len(self.keys)):
            self.keys[c], k = jax.random.split(self.keys[c])
            out.append(np.asarray(jax.random.normal(k, (q.shape[1],), jnp.float64)))
        return torch.as_tensor(np.stack(out), dtype=q.dtype)

    def direction(self, q, active):
        out = []
        for c, on in enumerate(active.tolist()):
            if on:
                self.keys[c], kd, self.sub[c], self.bias[c] = jax.random.split(self.keys[c], 4)
            out.append(bool(jax.random.bernoulli(kd)) if on else False)
        return torch.tensor(out)

    def leaf_uniform(self, q, active):
        out = []
        for c, on in enumerate(active.tolist()):
            if on:
                self.sub[c], k = jax.random.split(self.sub[c])
            out.append(float(jax.random.uniform(k, (), jnp.float64)) if on else 0.5)
        return torch.tensor(out, dtype=q.dtype)

    def bias_uniform(self, q, active):
        return torch.tensor([float(jax.random.uniform(self.bias[c], (), jnp.float64)) if on
                             else 0.5 for c, on in enumerate(active.tolist())], dtype=q.dtype)


class JaxHmcDraws:
    """The draw sites of ``hmc_kernel`` from the JAX package's key split
    (``hmc.py:79-101``), one key a chain."""

    def __init__(self, keys):
        self.k = [jax.random.split(k, 3) for k in keys]  # (mom, acc, len) a chain

    def momentum(self, q):
        return torch.as_tensor(np.stack([np.asarray(jax.random.normal(k[0], (q.shape[1],),
                                                                      jnp.float64))
                                         for k in self.k]), dtype=q.dtype)

    def trajectory_length(self, q, high):
        return torch.tensor([int(jax.random.randint(k[2], (), 1, high + 1)) for k in self.k])

    def accept_uniform(self, q):
        return torch.tensor([float(jax.random.uniform(k[1], (), jnp.float64)) for k in self.k],
                            dtype=q.dtype)


def _keys(seed, n):
    return list(jax.random.split(jax.random.PRNGKey(seed), n))


def _jax_transition(kernel_fn, ld_and_grad, keys, q0, step_sizes, inv_mass):
    """Each chain's transition by the JAX package's kernel under its key."""
    outs = []
    for c, key in enumerate(keys):
        state = jhmc.hmc_init(ld_and_grad, jnp.asarray(q0[c]))
        new, info = kernel_fn(key, state, jnp.float64(step_sizes[c]), jnp.asarray(inv_mass[c]))
        outs.append((new, info))
    return outs


def _check_nuts(port, jax_outs):
    new, info = port
    for c, (jn, ji) in enumerate(jax_outs):
        assert int(info.num_steps[c]) == int(ji.num_steps), c
        assert int(info.depth[c]) == int(ji.depth), c
        assert bool(info.diverging[c]) == bool(ji.diverging), c
        np.testing.assert_allclose(_n(new.q[c]), np.asarray(jn.q), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(float(new.logdens[c]), float(jn.logdens), rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(float(info.accept_prob[c]), float(ji.accept_prob),
                                   rtol=1e-10, atol=1e-10)


def _check_hmc(port, jax_outs):
    new, (ap, acc, _) = port
    for c, (jn, (jap, jacc, _)) in enumerate(jax_outs):
        assert bool(acc[c]) == bool(jacc), c
        np.testing.assert_allclose(_n(new.q[c]), np.asarray(jn.q), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(float(new.logdens[c]), float(jn.logdens), rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(float(ap[c]), float(jap), rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# Adaptation
# ---------------------------------------------------------------------------


def test_dual_averaging_sequence_matches_jax():
    rng = np.random.default_rng(0)
    accepts = rng.uniform(size=40)
    js = jad.da_init(jnp.float64(0.1))
    ts = tad.da_init(torch.tensor(0.1, dtype=F64))
    for i, a in enumerate(accepts):
        js = jad.da_update(js, jnp.float64(a), target=0.8)
        ts = tad.da_update(ts, torch.tensor(a, dtype=F64), target=0.8)
        if i == 20:  # a window end re-initialises around the current step
            js, ts = jad.da_init(jnp.exp(js.log_step)), tad.da_init(torch.exp(ts.log_step))
        for jf, tf in zip(js, ts):
            np.testing.assert_allclose(_n(tf), np.asarray(jf), rtol=1e-15, atol=0)


def test_welford_matches_jax():
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(30, 5)) * np.arange(1, 6)
    jw, tw = jad.welford_init(5, jnp.float64), tad.welford_init(5, F64)
    for x in xs:
        jw = jad.welford_update(jw, jnp.asarray(x))
        tw = tad.welford_update(tw, torch.as_tensor(x))
    for jf, tf in zip(jw, tw):
        np.testing.assert_array_equal(_n(tf), np.asarray(jf))
    for reg in (True, False):
        np.testing.assert_array_equal(_n(tad.welford_variance(tw, reg)),
                                      np.asarray(jad.welford_variance(jw, reg)))
    # the batched state (a leading chain axis) is the per-chain state
    tb = tad.welford_init(5, F64, batch=(2,))
    for x in xs:
        tb = tad.welford_update(tb, torch.as_tensor(np.stack([x, 2 * x])))
    np.testing.assert_array_equal(_n(tb.mean[0]), _n(tw.mean))
    np.testing.assert_array_equal(_n(tad.welford_variance(tb)[0]), _n(tad.welford_variance(tw)))


@pytest.mark.parametrize("num_warmup", [0, 1, 10, 64, 149, 150, 500, 1000, 1003])
def test_window_schedule_matches_jax(num_warmup):
    tw, te = tad.window_schedule(num_warmup)
    jw, je = jad.window_schedule(num_warmup)
    assert isinstance(tw, np.ndarray) and tw.dtype == bool
    np.testing.assert_array_equal(tw, np.asarray(jw))
    np.testing.assert_array_equal(te, np.asarray(je))


# ---------------------------------------------------------------------------
# leapfrog and exact transitions on a correlated Gaussian
# ---------------------------------------------------------------------------

_A = np.array([[2.0, 0.0, 0.0, 0.0, 0.0], [1.5, 0.5, 0.0, 0.0, 0.0],
               [-1.0, 0.3, 0.2, 0.0, 0.0], [0.2, -0.4, 0.1, 1.0, 0.0],
               [0.0, 0.5, -0.3, 0.2, 0.7]])
_MU = np.array([1.0, -2.0, 0.5, 0.0, 0.3])
_PREC = np.linalg.inv(_A @ _A.T)


def _gauss_jax(q):
    d = q - jnp.asarray(_MU)
    return -0.5 * d @ jnp.asarray(_PREC) @ d


def _gauss_torch(q):
    d = q - torch.as_tensor(_MU)
    return -0.5 * d @ torch.as_tensor(_PREC) @ d


def test_leapfrog_matches_jax():
    rng = np.random.default_rng(2)
    q, p = rng.normal(size=5), rng.normal(size=5)
    inv_mass = rng.uniform(0.5, 2.0, size=5)
    jvg = jax.value_and_grad(_gauss_jax)
    ld, g = jvg(jnp.asarray(q))
    jout = jhmc.leapfrog(jvg, jhmc.IntegratorState(jnp.asarray(q), jnp.asarray(p), ld, g),
                         jnp.float64(0.17), jnp.asarray(inv_mass), 7)
    f = logdensity_and_grad(_gauss_torch, lambda v: v, "vmap")
    q_t = torch.as_tensor(q)[None]
    ld_t, g_t = f(q_t)
    tout = leapfrog(f, IntegratorState(q_t, torch.as_tensor(p)[None], ld_t, g_t), 0.17,
                    torch.as_tensor(inv_mass), 7)
    for jf, tf in zip(jout, tout):
        np.testing.assert_allclose(_n(tf[0]), np.asarray(jf), rtol=1e-12, atol=1e-12)


# step sizes from small (full trees of depth 6) to large (a divergence); in
# between, trees that stop inside a subtree, at a U-turn
_STEPS = [0.01, 0.04, 0.12, 0.5]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nuts_transition_matches_jax_gaussian(seed):
    rng = np.random.default_rng(10 + seed)
    q0 = _MU + 0.3 * rng.normal(size=(4, 5))
    inv_mass = rng.uniform(0.5, 2.0, size=(4, 5))
    keys = _keys(seed, 4)
    jouts = _jax_transition(jnuts.nuts_kernel(jax.value_and_grad(_gauss_jax), max_depth=6),
                            jax.value_and_grad(_gauss_jax), keys, q0, _STEPS, inv_mass)
    f = logdensity_and_grad(_gauss_torch, lambda v: v, "vmap")
    q = torch.as_tensor(q0)
    state = HMCState(q, *f(q))
    port = nuts_kernel(f, max_depth=6)(JaxNutsDraws(keys), state, torch.tensor(_STEPS, dtype=F64),
                                       torch.as_tensor(inv_mass))
    _check_nuts(port, jouts)
    assert len({int(d) for d in port[1].depth}) > 1  # the chains stopped apart


@pytest.mark.parametrize("seed", [0, 1])
def test_hmc_transition_matches_jax_gaussian(seed):
    rng = np.random.default_rng(20 + seed)
    q0 = _MU + 0.3 * rng.normal(size=(4, 5))
    inv_mass = rng.uniform(0.5, 2.0, size=(4, 5))
    keys = _keys(100 + seed, 4)
    jvg = jax.value_and_grad(_gauss_jax)
    jouts = _jax_transition(jhmc.hmc_kernel(jvg, num_integration_steps=9), jvg, keys, q0,
                            _STEPS, inv_mass)
    f = logdensity_and_grad(_gauss_torch, lambda v: v, "loop")
    q = torch.as_tensor(q0)
    port = hmc_kernel(f, num_integration_steps=9)(
        JaxHmcDraws(keys), HMCState(q, *f(q)), torch.tensor(_STEPS, dtype=F64),
        torch.as_tensor(inv_mass))
    _check_hmc(port, jouts)


# ---------------------------------------------------------------------------
# Exact transitions on the GP hyperparameter density, kernel path
# ---------------------------------------------------------------------------

N_GP = 1024


def _gp_data():
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.uniform(size=(N_GP, 8)), dtype=torch.float32)
    y = torch.as_tensor(rng.normal(size=N_GP), dtype=torch.float32)
    return x, y


def _gp_lml(x, y):
    """log p(y | θ = exp(q)) for σ²·Matérn-3/2(ℓ) + noise, at f32 (the
    kernel path at this size), as an f64 scalar."""

    def lml(q):
        th = torch.exp(q.to(torch.float32))
        k = th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1])
        return agt.GP(k)(x, th[2]).logpdf(y).to(q.dtype)
    return lml


def test_transitions_match_jax_gp_hyper_density_kernel_path(monkeypatch):
    x, y = _gp_data()
    lml = _gp_lml(x, y)
    monkeypatch.setattr(blocked_chol, "_INTERPRET", True)
    monkeypatch.setattr(fused_gram, "_INTERPRET", True)
    calls = {"logpdf_contraction": 0}
    orig = fused_gram.logpdf_contraction

    def spy(*a):
        calls["logpdf_contraction"] += 1
        return orig(*a)

    monkeypatch.setattr(fused_gram, "logpdf_contraction", spy)
    # the f32 lml's value and q-gradient at each f32 q the port evaluated,
    # read back by the JAX sampler
    seen = {}
    base = logdensity_and_grad(lml, lambda v: v, "loop")

    def ld_and_grad(q, active=None):
        ld, g = base(q, active)
        for c in range(q.shape[0]):
            if active is None or active[c]:
                seen[_n(q[c]).astype(np.float32).tobytes()] = (float(ld[c]), _n(g[c]))
        return ld - 0.5 * torch.sum(q * q, dim=1), g - q

    def host(q):
        key = np.asarray(q).astype(np.float32).tobytes()
        if key not in seen:
            ld_and_grad(torch.as_tensor(np.asarray(q))[None])
        lp, g = seen[key]
        return np.float64(lp), g.astype(np.float64)

    def jax_ld_and_grad(q):
        lp, g = jax.pure_callback(host, (jax.ShapeDtypeStruct((), jnp.float64),
                                         jax.ShapeDtypeStruct((3,), jnp.float64)), q)
        return lp - 0.5 * jnp.sum(q * q), g - q

    rng = np.random.default_rng(6)
    q0 = rng.uniform(-0.05, 0.05, size=(2, 3))
    inv_mass = np.ones((2, 3))
    steps = [0.05, 0.4]
    q = torch.as_tensor(q0)
    state = HMCState(q, *ld_and_grad(q))
    assert calls["logpdf_contraction"] == 2  # the fused backward ran

    keys = _keys(7, 2)
    port = nuts_kernel(ld_and_grad, max_depth=3)(JaxNutsDraws(keys), state,
                                                 torch.tensor(steps, dtype=F64),
                                                 torch.as_tensor(inv_mass))
    jouts = _jax_transition(jnuts.nuts_kernel(jax_ld_and_grad, max_depth=3), jax_ld_and_grad,
                            keys, q0, steps, inv_mass)
    _check_nuts(port, jouts)
    assert np.isfinite(_n(port[0].logdens)).all()

    keys = _keys(8, 2)
    port = hmc_kernel(ld_and_grad, num_integration_steps=2)(
        JaxHmcDraws(keys), state, torch.tensor(steps, dtype=F64), torch.as_tensor(inv_mass))
    jouts = _jax_transition(jhmc.hmc_kernel(jax_ld_and_grad, num_integration_steps=2),
                            jax_ld_and_grad, keys, q0, steps, inv_mass)
    _check_hmc(port, jouts)


def test_non_pd_gram_on_kernel_path_is_a_rejection(monkeypatch):
    # tiny noise and a huge ℓ: the f32 gram is not PD; the fused path gives
    # a NaN logdensity (no raise, no hang), the guard makes it −inf with a
    # zero gradient, and a trajectory that lands there is rejected
    x, y = _gp_data()
    monkeypatch.setattr(blocked_chol, "_INTERPRET", True)
    monkeypatch.setattr(fused_gram, "_INTERPRET", True)
    lml = _gp_lml(x, y)
    q_bad = torch.tensor([0.0, np.log(50.0), np.log(1e-9)], dtype=F64)
    raw = lml(q_bad.clone().requires_grad_())
    assert not torch.isfinite(raw)
    f = logdensity_and_grad(lml, lambda v: v, "loop")
    ld, g = f(q_bad[None])
    assert float(ld[0]) == -np.inf and torch.equal(g, torch.zeros_like(g))

    class OneStepTo:
        """One leapfrog of unit step whose momentum lands on ``target``."""

        def __init__(self, q0, g0, target):
            self.p = target - q0 - 0.5 * g0

        def momentum(self, q):
            return self.p

        def trajectory_length(self, q, high):
            return torch.ones(q.shape[0], dtype=torch.int64)

        def accept_uniform(self, q):
            return torch.zeros(q.shape[0], dtype=q.dtype)

    q0 = torch.zeros((1, 3), dtype=F64)
    state = HMCState(q0, *f(q0))
    new, (ap, acc, _) = hmc_kernel(f, 1)(OneStepTo(q0, state.grad, q_bad[None]), state,
                                        1.0, torch.ones(3, dtype=F64))
    assert float(ap[0]) == 0.0 and not bool(acc[0])
    assert torch.equal(new.q, q0) and float(new.logdens[0]) == float(state.logdens[0])


@pytest.mark.parametrize("path", ["gram_logpdf_core", "cholesky_gram"])
def test_hyperparameters_unbound_from_one_tensor(path):
    # ``s2, ell, noise = torch.exp(q)``: the three are outputs of one autograd
    # node; the fused backwards differentiate the kernel again and must stop
    # at them (before the repair the inner backward ran into the caller's
    # graph and the outer one raised "backward through the graph a second
    # time"); the gradient equals that of the indexed form and of f64
    x, y = _gp_data()
    x, y = x[:100], y[:100]

    def grad(dtype, unbind):
        q = torch.tensor([0.1, -0.3, np.log(0.1)], dtype=dtype, requires_grad=True)
        th = torch.exp(q)
        s2, ell, noise = th if unbind else (th[0], th[1], th[2])
        fx = agt.GP(s2 * agt.with_lengthscale(agt.Matern32Kernel(), ell))(x.to(dtype), noise)
        lp = fx.logpdf(y.to(dtype)) if path == "gram_logpdf_core" else \
            fx.to_mvnormal().logpdf(y.to(dtype))
        return torch.autograd.grad(lp, q)[0]

    with small_kernel_paths():
        got = grad(torch.float32, True)
        want = grad(torch.float32, False)
    np.testing.assert_array_equal(_n(got), _n(want))
    np.testing.assert_allclose(_n(got), _n(grad(F64, True)), rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# chain_eval
# ---------------------------------------------------------------------------


def _latent_poisson(n=12):
    """A latent-Poisson joint with a diagonal whitening (each latent its own
    scale): a density without products across dimensions, so "vmap" and
    "loop" give the same bits (a matvec's batched product rounds apart by
    ~1e-15, which leapfrog trajectories amplify over transitions)."""
    rng = np.random.default_rng(9)
    scale = torch.as_tensor(rng.uniform(0.3, 1.2, size=n))
    y = torch.as_tensor(rng.poisson(np.exp(0.5 + _n(scale) * rng.normal(size=n))).astype(float))

    def logjoint(v):
        u = 0.5 + scale * v
        return -0.5 * torch.sum(v * v) + torch.sum(y * u - torch.exp(u) - torch.lgamma(y + 1.0))
    return logjoint


def test_chain_eval_vmap_and_loop_give_the_same_draws():
    ld = _latent_poisson()
    init = init_chain_positions(3, torch.zeros(12, dtype=F64), num_chains=3, jitter=0.3)
    runs = [run_mcmc(ld, init, 11, num_chains=3, num_samples=20, num_warmup=20, max_depth=6,
                     chain_eval=mode) for mode in ("vmap", "loop")]
    a, b = runs
    assert torch.equal(a.num_steps, b.num_steps)
    for fa, fb in ((a.positions, b.positions), (a.logdens, b.logdens),
                   (a.step_size, b.step_size), (a.inv_mass, b.inv_mass)):
        np.testing.assert_allclose(_n(fa), _n(fb), rtol=1e-12, atol=1e-12)
    assert a.positions.shape == (3, 20, 12) and np.isfinite(_n(a.logdens)).all()


def test_chain_eval_vmap_on_the_fused_density_raises():
    x, y = _gp_data()
    x, y = x[:100], y[:100]
    with small_kernel_paths():
        lml = _gp_lml(x, y)
        init = init_chain_positions(0, torch.zeros(3, dtype=F64), num_chains=2, jitter=0.05)
        with pytest.raises(RuntimeError, match="chain_eval='loop'"):
            run_mcmc(lml, init, 1, num_chains=2, num_samples=1, num_warmup=1,
                     chain_eval="vmap")
        res = run_mcmc(lml, init, 1, num_chains=2, num_samples=2, num_warmup=2, max_depth=3,
                       chain_eval="loop")
    assert np.isfinite(_n(res.logdens)).all()
    with pytest.raises(ValueError, match="chain_eval"):
        run_mcmc(lml, init, 1, num_chains=2, chain_eval="pmap")


def test_tree_positions_and_generators():
    # a dict position comes back as a dict of (chains, draws, ...) leaves; a
    # seed and a generator with that seed give the same run
    def ld(t):
        return -0.5 * (torch.sum(t["a"] ** 2) + 4.0 * t["b"] ** 2)

    pos = {"a": torch.zeros(2, dtype=F64), "b": torch.tensor(0.0, dtype=F64)}
    init = init_chain_positions(torch.Generator().manual_seed(4), pos, num_chains=2)
    assert init["a"].shape == (2, 2) and init["b"].shape == (2,)
    r1 = run_mcmc(ld, init, 5, num_chains=2, num_samples=6, num_warmup=6)
    r2 = run_mcmc(ld, init, torch.Generator().manual_seed(5), num_chains=2, num_samples=6,
                  num_warmup=6)
    assert r1.positions["a"].shape == (2, 6, 2) and r1.positions["b"].shape == (2, 6)
    assert torch.equal(r1.positions["a"], r2.positions["a"])
    single = run_mcmc(ld, pos, 5, num_samples=3, num_warmup=3)
    assert single.positions["a"].shape == (1, 3, 2)


# ---------------------------------------------------------------------------
# Moments (tests/test_mcmc.py, cut to size)
# ---------------------------------------------------------------------------


def _check_mean(draws, mu, nsigma=4.0):
    """Each component's mean within ``nsigma`` Monte-Carlo standard errors
    (sd/√ESS, the bulk ESS of the port's diagnostics, which
    tests/test_torch_latent.py holds against the JAX package's)."""
    from abstractgps_tpu_torch.inference.mcmc import diagnostics

    d = _n(draws)
    for i, m in enumerate(mu):
        x = d[..., i]
        se = x.std() / np.sqrt(diagnostics.ess(x))
        assert abs(x.mean() - m) <= nsigma * se, (i, x.mean(), m, se)


@pytest.mark.parametrize("algorithm", ["nuts", "hmc"])
def test_standard_normal_moments(algorithm):
    dim = 4

    def ld(q):
        return -0.5 * torch.sum(q * q)

    init = init_chain_positions(0, torch.zeros(dim, dtype=F64), num_chains=4)
    res = run_mcmc(ld, init, 1, num_samples=200, num_warmup=100, num_chains=4,
                   algorithm=algorithm, num_integration_steps=12, initial_step_size=0.5)
    _check_mean(res.positions, np.zeros(dim))
    qs = _n(res.positions).reshape(-1, dim)
    np.testing.assert_allclose(qs.var(0), np.ones(dim), atol=0.2)
    assert float(res.accept_prob.mean()) > 0.6


def test_correlated_gaussian_moments():
    # N(mu, Sigma) with strong correlation: exercises mass adaptation
    A = np.array([[2.0, 0.0, 0.0], [1.5, 0.5, 0.0], [-1.0, 0.3, 0.2]])
    mu, Sigma = np.array([1.0, -2.0, 0.5]), A @ A.T
    prec = torch.as_tensor(np.linalg.inv(Sigma))

    def ld(q):
        d = q - torch.as_tensor(mu)
        return -0.5 * d @ prec @ d

    init = init_chain_positions(2, torch.zeros(3, dtype=F64), num_chains=2)
    res = run_mcmc(ld, init, 3, num_samples=200, num_warmup=120, num_chains=2, max_depth=6)
    _check_mean(res.positions, mu)
    qs = _n(res.positions).reshape(-1, 3)
    np.testing.assert_allclose(np.cov(qs.T), Sigma, atol=0.5, rtol=0.3)
    assert float(res.diverging.double().mean()) < 0.05


# ---------------------------------------------------------------------------
# set_enabled
# ---------------------------------------------------------------------------


def test_set_enabled_false_takes_the_library_path(monkeypatch):
    x, y = _gp_data()
    x, y = x[:150], y[:150]
    theta = [torch.tensor(v, dtype=torch.float32, requires_grad=True) for v in (1.2, 0.7, 0.1)]

    def lml_and_grad():
        k = theta[0] * agt.with_lengthscale(agt.Matern32Kernel(), theta[1])
        lp = agt.GP(k)(x, theta[2]).logpdf(y)
        return lp, torch.autograd.grad(lp, theta)

    want_lp, want_g = lml_and_grad()  # CPU, no interpret: the library path
    A = torch.eye(150, dtype=torch.float32)
    B = torch.ones((150, 40), dtype=torch.float32)
    with small_kernel_paths() as mp:
        calls = []
        for mod, name in ((blocked_chol, "slab_factor"), (blocked_chol, "chol_inv_block"),
                          (blocked_chol, "tri_inv_block"), (fused_gram, "gram_tile"),
                          (fused_gram, "logpdf_contraction"), (fused_gram, "gram_bwd")):
            def spy(*a, _f=getattr(mod, name), _name=name):
                calls.append(_name)
                return _f(*a)
            mp.setattr(mod, name, spy)
        gates = lambda: [blocked_chol.should_use_pallas(A),  # noqa: E731
                         blocked_chol.should_use_fused_gram(x, y),
                         covmat._wide_rhs(A, B),
                         fused_gram.should_use_kernel(x, x)]
        assert gates() == [True] * 4
        lml_and_grad()
        assert {"slab_factor", "gram_tile", "logpdf_contraction"} <= set(calls)
        calls.clear()
        blocked_chol.set_enabled(False)
        fused_gram.set_enabled(False)
        try:
            assert gates() == [False] * 4
            before = dict(cuda.LAUNCHES)
            lp, g = lml_and_grad()
            mu, var = agt.posterior(agt.GP(agt.Matern32Kernel())(x, 0.1), y).mean_and_var(x[:40])
        finally:
            blocked_chol.set_enabled(True)
            fused_gram.set_enabled(True)
    assert calls == [] and cuda.LAUNCHES == before
    assert float(lp.detach()) == float(want_lp.detach())
    for a, b in zip(g, want_g):
        assert float(a) == float(b)
    assert torch.isfinite(mu).all() and torch.isfinite(var).all()
