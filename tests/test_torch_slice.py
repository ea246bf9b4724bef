"""The whole slice — GP → FiniteGP.logpdf → posterior → mean_and_var — of
the port against the JAX package.

- f64 on the library path, against the independent golden constants of
  tests/test_goldens.py at 1e-9 (the JAX package's own tolerance there).
- f32 through the kernel sweep (both packages in interpret mode at small
  sizes): 64-wide slabs of 16-wide blocks, a 32-wide tail slab, and the
  row-panel trtri behind the wide prediction solves; f32 tolerance ~1e-5
  relative, as in tests/test_pallas_kernels.py.

- The calls whose backward was not ported in the first slice (the fused
  logpdf, the wide solves, the blocked Cholesky) against the gradients of
  their dense formulations.

The JAX side is computed once per module: its interpret-mode tracing takes
seconds per call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_goldens import (
    GOLDEN_LOGPDF,
    GOLDEN_POST_MEAN,
    GOLDEN_POST_VAR,
    GOLDEN_POSTPRED_LOGPDF,
)
from torch_port_helpers import kernel_tree, small_kernel_paths, spd

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu.ops import pallas_chol
from abstractgps_tpu_torch.ops import blocked_chol, distance

N, M, D = 150, 40, 2


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


def _n(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# f64 library path against the goldens
# ---------------------------------------------------------------------------


def _readme_model():
    x = (torch.arange(10, dtype=torch.float64) + 0.5) / 10.0
    fx = agt.GP(agt.Matern32Kernel())(x, 0.001)
    return fx, x, torch.sin(x)


def test_readme_goldens_f64():
    fx, x, y = _readme_model()
    np.testing.assert_allclose(float(fx.logpdf(y)), GOLDEN_LOGPDF, rtol=0, atol=1e-9)
    post = agt.posterior(fx, y)
    np.testing.assert_allclose(float(post(x, 0.001).logpdf(y)), GOLDEN_POSTPRED_LOGPDF,
                               rtol=0, atol=1e-9)
    xt = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0], dtype=torch.float64)
    mu, var = post.mean_and_var(xt)
    np.testing.assert_allclose(_n(mu), GOLDEN_POST_MEAN, rtol=0, atol=1e-9)
    np.testing.assert_allclose(_n(var), GOLDEN_POST_VAR, rtol=0, atol=1e-9)
    # the other moments of the posterior agree with its fused variants
    np.testing.assert_allclose(_n(post.mean(xt)), GOLDEN_POST_MEAN, rtol=0, atol=1e-9)
    np.testing.assert_allclose(_n(post.var(xt)), GOLDEN_POST_VAR, rtol=0, atol=1e-9)
    m, C = post.mean_and_cov(xt)
    np.testing.assert_allclose(_n(torch.diagonal(C)), GOLDEN_POST_VAR, rtol=0, atol=1e-9)
    np.testing.assert_allclose(_n(post.cov(xt, xt)), _n(C), rtol=0, atol=1e-12)
    assert float(agt.approx_log_evidence(agt.ExactInference(), fx, y)) == float(fx.logpdf(y))
    np.testing.assert_allclose(_n(agt.posterior(agt.ExactInference(), fx, y).mean(xt)),
                               _n(mu), rtol=1e-12)


def test_sequential_posterior_equals_batch(rng):
    x = torch.as_tensor(rng.uniform(size=(20, 2)))
    y = torch.as_tensor(rng.normal(size=20))
    xt = torch.as_tensor(rng.uniform(size=(6, 2)))
    f = agt.GP(0.3, 1.2 * agt.with_lengthscale(agt.SEKernel(), 0.7))
    batch = agt.posterior(f(x, 0.05), y)
    first = agt.posterior(f(x[:12], 0.05), y[:12])
    seq = agt.posterior(first(x[12:], 0.05), y[12:])
    for a, b in zip(seq.mean_and_var(xt), batch.mean_and_var(xt)):
        np.testing.assert_allclose(_n(a), _n(b), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_n(seq.data.L), _n(batch.data.L), rtol=1e-10, atol=1e-12)
    assert isinstance(seq.data.noise, agt.DiagonalNoise)


def test_library_path_matches_jax_f64(rng):
    x = rng.uniform(size=(30, D))
    y = rng.normal(size=30)
    xs = rng.uniform(size=(8, D))
    kj = 1.3 * agp.with_lengthscale(agp.Matern32Kernel(), 0.7)
    kt = agt.kernel_from_numpy(kernel_tree(kj))
    fj, ft = agp.GP(kj)(x, 0.1), agt.GP(kt)(torch.as_tensor(x), 0.1)
    np.testing.assert_allclose(float(ft.logpdf(torch.as_tensor(y)).detach()), float(fj.logpdf(y)),
                               rtol=1e-12)
    mj, vj = agp.posterior(fj, y).mean_and_var(xs)
    mt, vt = agt.posterior(ft, torch.as_tensor(y)).mean_and_var(torch.as_tensor(xs))
    np.testing.assert_allclose(_n(mt), np.asarray(mj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_n(vt), np.asarray(vj), rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# f32 through the kernel sweep, against the JAX package's interpret path
# ---------------------------------------------------------------------------


def _data():
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(N, D)).astype(np.float32)
    y = rng.normal(size=N).astype(np.float32)
    xs = rng.uniform(size=(M, D)).astype(np.float32)
    return x, y, xs


def _jax_kernel():
    # f32 hyperparameters: under the suite's x64 mode, Python floats would
    # make the JAX kernel f64 and mean_and_var would mix f32 L with f64 K
    return jnp.float32(1.2) * agp.with_lengthscale(agp.Matern32Kernel(), jnp.float32(0.4))


@pytest.fixture(scope="module")
def jax_slice():
    x, y, xs = _data()
    with small_kernel_paths():
        fx = agp.GP(_jax_kernel())(jnp.asarray(x), jnp.float32(0.1))
        assert pallas_chol.should_use_fused_gram(fx.x, fx.noise.diag().astype(jnp.float32))
        lp = float(fx.logpdf(jnp.asarray(y)))
        post = agp.posterior(fx, jnp.asarray(y))
        mu, var = post.mean_and_var(jnp.asarray(xs))
        return lp, np.asarray(mu), np.asarray(var)


def _torch_slice():
    x, y, xs = _data()
    k = agt.kernel_from_numpy(kernel_tree(_jax_kernel()), dtype=torch.float32)
    fx = agt.GP(k)(torch.as_tensor(x), 0.1)
    lp = fx.logpdf(torch.as_tensor(y))
    post = agt.posterior(fx, torch.as_tensor(y))
    mu, var = post.mean_and_var(torch.as_tensor(xs))
    return fx, lp, mu, var


def test_slice_f32_matches_jax_sweep(jax_slice, monkeypatch):
    lp_j, mu_j, var_j = jax_slice
    calls = {"slab_factor": 0, "chol_inv_block": 0, "tri_inv_block": 0}
    with small_kernel_paths() as mp:
        # count the sweep's calls of the kernel wrappers (on the CPU they
        # run the plain versions and count no launch)
        for name in calls:
            wrapper = getattr(blocked_chol, name)

            def spy(*a, _wrapper=wrapper, _name=name):
                calls[_name] += 1
                return _wrapper(*a)

            mp.setattr(blocked_chol, name, spy)
        fx, lp, mu, var = _torch_slice()
    assert fx.x.dtype == torch.float32 and lp.dtype == torch.float32
    # logpdf and posterior: 2 full 64-wide slabs each; the 32-wide tail of
    # npad = 160 goes block by block; the prediction solve has nb = 10
    # blocks (not a power of two) → the row-panel trtri, its diagonal blocks
    # in one batched call
    assert calls == {"slab_factor": 4, "chol_inv_block": 4, "tri_inv_block": 1}
    np.testing.assert_allclose(float(lp.detach()), lp_j, rtol=1e-5)
    assert mu.shape == (M,) and var.shape == (M,)
    # the mean goes through α = K⁻¹δ: κ(K) ≈ 740 here, so each package's f32
    # mean is ~κ·eps ≈ 4e-5 (relative to its largest entry) off the f64
    # truth (measured 3.9e-5 JAX, 4.6e-5 port): the two agree to twice that
    np.testing.assert_allclose(_n(mu), mu_j, rtol=1e-5, atol=1e-4 * np.abs(mu_j).max())
    np.testing.assert_allclose(_n(var), var_j, rtol=1e-4, atol=1e-5 * np.abs(var_j).max())
    assert np.all(np.isfinite(_n(var))) and _n(var).min() >= 0.0


def test_slice_f32_matches_f64_oracle():
    # the f32 sweep against an f64 dense oracle on the same inputs
    x, y, xs = _data()
    with small_kernel_paths():
        _, lp, mu, var = _torch_slice()
    k64 = agt.kernel_from_numpy(kernel_tree(_jax_kernel()))
    x64, y64, xs64 = (torch.as_tensor(a, dtype=torch.float64) for a in (x, y, xs))
    fx64 = agt.GP(k64)(x64, 0.1)
    mu64, var64 = agt.posterior(fx64, y64).mean_and_var(xs64)
    np.testing.assert_allclose(float(lp.detach()), float(fx64.logpdf(y64).detach()), rtol=2e-5)
    np.testing.assert_allclose(_n(mu), _n(mu64), rtol=0, atol=1e-4 * np.abs(_n(mu64)).max())
    np.testing.assert_allclose(_n(var), _n(var64), rtol=0, atol=1e-4 * _n(var64).max())


def _dense_solve(which):
    """The dense formulations of the wide solves and of the Cholesky."""
    lower = lambda L, B: torch.linalg.solve_triangular(L, B, upper=False)  # noqa: E731
    upper = lambda L, B: torch.linalg.solve_triangular(L.T, B, upper=True)  # noqa: E731
    return {"solve_lower_wide": lower, "solve_upper_wide": upper,
            "chol_solve_wide": lambda L, B: upper(L, lower(L, B))}[which]


@pytest.mark.parametrize("call", ["logpdf", "solve_lower_wide", "solve_upper_wide",
                                  "chol_solve_wide", "pallas_cholesky"])
def test_backward_matches_dense_formulation(call):
    # the calls whose backward raised before the training path was ported
    # now return gradients, equal to those of the dense formulation (f32,
    # well-conditioned inputs: 2e-5 relative; the logpdf against f64 at the
    # f32 gradient tolerance of tests/test_pallas_kernels.py:263)
    x, y, _ = _data()
    with small_kernel_paths():
        if call == "logpdf":
            k = agt.kernel_from_numpy(kernel_tree(_jax_kernel()), dtype=torch.float32)
            lp = agt.GP(k)(torch.as_tensor(x), 0.1).logpdf(torch.as_tensor(y))
            lp.backward()
            k64 = agt.kernel_from_numpy(kernel_tree(_jax_kernel()))
            agt.GP(k64)(torch.as_tensor(x, dtype=torch.float64), 0.1).logpdf(
                torch.as_tensor(y, dtype=torch.float64)).backward()
            for p, p64 in zip(k.parameters(), k64.parameters()):
                np.testing.assert_allclose(_n(p.grad), _n(p64.grad), rtol=2e-3, atol=2e-4)
            return
        rng = np.random.default_rng(3)
        if call == "pallas_cholesky":
            A = torch.as_tensor(spd(rng, 64), dtype=torch.float32)
            w = torch.as_tensor(rng.normal(size=(64, 64)), dtype=torch.float32)
            got, want = (torch.autograd.grad(torch.sum(f(A_) * w), A_)[0]
                         for f, A_ in ((blocked_chol.pallas_cholesky, A.clone().requires_grad_()),
                                       (torch.linalg.cholesky, A.clone().requires_grad_())))
            want = 0.5 * (want + want.T)  # the JAX rule's symmetric Ā
            np.testing.assert_allclose(_n(got), _n(want), rtol=2e-5, atol=2e-5 * float(want.abs().max()))
            return
        L = torch.linalg.cholesky(torch.as_tensor(spd(rng, 64), dtype=torch.float32))
        B = torch.as_tensor(rng.normal(size=(64, 20)), dtype=torch.float32)
        w = torch.as_tensor(rng.normal(size=(64, 20)), dtype=torch.float32)
        grads = []
        for f in (getattr(blocked_chol, call), _dense_solve(call)):
            L_, B_ = L.clone().requires_grad_(), B.clone().requires_grad_()
            grads.append(torch.autograd.grad(torch.sum(f(L_, B_) * w), [L_, B_]))
        for got, want in zip(*grads):
            want = torch.tril(want) if want.shape == L.shape else want
            np.testing.assert_allclose(_n(torch.tril(got) if got.shape == L.shape else got),
                                       _n(want), rtol=2e-5, atol=2e-5 * float(want.abs().max()))
