"""The exact posterior's held inverse ``W = L⁻¹`` on the kernel paths in
interpret mode (both packages at the small sizes of
``torch_port_helpers.SMALL``: 16-wide blocks, kernel paths from N = 32,
wide solves from q = 16).

- W is formed once, by ``blocked_chol.lower_inverse`` in the posterior's
  ``covmat.Whitener``, by the first whitening predictive, and every
  predictive whitens by one product with it at q = 1, 15, 16 and 40, on
  either side of ``_WIDE_RHS``. The answers
  agree with the per-query path (``covmat.solve_lower``: substitution below
  q = 16, the wide solve from there) and with the JAX package's posterior.
- A posterior whose hyperparameters carry a graph keeps the per-query path,
  its gradient with respect to them unchanged, and forms no W; a gradient
  in x* through a fixed posterior is as accurate as the per-query path's,
  also where W was formed under ``torch.inference_mode``.
- ``substitution_solves()``, ``set_enabled(False)`` and f64 inputs keep the
  per-query path and form no W; a sequential posterior forms its own W of
  its extended factor.

Tolerances are the wide-solve tests' (tests/test_torch_kernels.py): 1e-5
relative, with an absolute floor of 1e-5 of the quantity's scale (the
prior variance for the variances and covariances, whose quadratic form
cancels against it; the largest entry otherwise). The mean, which no
whitening touches, is held to the JAX package at the slice test's 1e-4 of
its largest entry (tests/test_torch_slice.py: κ(K)·eps each side). A
gradient in x* is held against its f64 truth at twice the per-query path's
own f32 error: the two paths round differently (substitution below q = 16),
by up to ~2e-5 of the largest entry at q = 1.

The JAX side is computed once per module at q = 40: its interpret-mode
tracing takes seconds a call, and each column of a prediction is computed
alone, so the first q columns are the answers at q.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import kernel_tree, small_kernel_paths

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu_torch.ops import blocked_chol, covmat
from abstractgps_tpu_torch.utils import profiling

N, Q, QZ, D = 150, 40, 7, 2  # N pads to 160: ten blocks, the row-panel trtri
S2, ELL, NOISE = 1.2, 0.4, 0.1
QS = [1, 15, 16, 40]


def _n(t):
    return t.detach().cpu().numpy()


def _data():
    rng = np.random.default_rng(11)
    x = rng.uniform(size=(N, D)).astype(np.float32)
    y = rng.normal(size=N).astype(np.float32)
    xs = rng.uniform(size=(Q, D)).astype(np.float32)
    zs = rng.uniform(size=(QZ, D)).astype(np.float32)
    return x, y, xs, zs


def _jax_kernel():
    return jnp.float32(S2) * agp.with_lengthscale(agp.Matern32Kernel(), jnp.float32(ELL))


def _posterior(n=N, dtype=torch.float32):
    """A fixed posterior: built under no_grad, so no gradient reaches its L
    (the kernel's hyperparameters are ``nn.Parameter``s)."""
    x, y, *_ = _data()
    k = agt.kernel_from_numpy(kernel_tree(_jax_kernel()), dtype=dtype)
    with torch.no_grad():
        fx = agt.GP(k)(torch.as_tensor(x[:n], dtype=dtype), NOISE)
        return agt.posterior(fx, torch.as_tensor(y[:n], dtype=dtype))


def _per_query(post, xs, zs):
    """The five predictives as the per-query path computes them."""
    L, prior, X = post.data.L, post.prior, post.data.x
    K = prior.cov(X, xs)
    mean = prior.mean(xs) + K.T @ post.data.alpha
    var = torch.clamp(prior.var(xs) - covmat.diag_Xt_invA_X(L, K), min=0.0)
    cov = prior.cov(xs) - covmat.Xt_invA_X(L, K)
    cov_z = prior.cov(xs, zs) - covmat.Xt_invA_Y(K, L, prior.cov(X, zs))
    return {"mean": mean, "var": var, "cov": cov, "cov_z": cov_z}


def _held(post, xs, zs):
    """The posterior's five predictives, as it answers them."""
    m, v = post.mean_and_var(xs)
    mc, C = post.mean_and_cov(xs)
    return {"mean": m, "var": v, "var_alone": post.var(xs), "cov": post.cov(xs),
            "cov_z": post.cov(xs, zs), "mean_of_cov": mc, "cov_of_mean": C}


def _close(got, want, atol):
    np.testing.assert_allclose(_n(got), _n(want) if torch.is_tensor(want) else want,
                               rtol=1e-5, atol=atol)


def _check(out, want, mean_atol):
    for name in ("mean", "mean_of_cov"):
        _close(out[name], want["mean"], mean_atol)
    for name, ref in (("var", "var"), ("var_alone", "var"), ("cov", "cov"),
                      ("cov_of_mean", "cov"), ("cov_z", "cov_z")):
        _close(out[name], want[ref], 1e-5 * S2)


@pytest.fixture(autouse=True)
def _paths():
    with small_kernel_paths() as mp:
        yield mp


@pytest.fixture(scope="module")
def jax_answers():
    x, y, xs, zs = _data()
    with small_kernel_paths():
        post = agp.posterior(agp.GP(_jax_kernel())(jnp.asarray(x), jnp.float32(NOISE)),
                             jnp.asarray(y))
        mu, var = post.mean_and_var(jnp.asarray(xs))
        cov = post.cov(jnp.asarray(xs))
        cov_z = post.cov(jnp.asarray(xs), jnp.asarray(zs))
    return {"mean": np.asarray(mu), "var": np.asarray(var), "cov": np.asarray(cov),
            "cov_z": np.asarray(cov_z)}


@pytest.mark.parametrize("q", QS)
def test_the_held_inverse_serves_every_predictive(_paths, jax_answers, q):
    _, _, xs, zs = _data()
    xq, zt = torch.as_tensor(xs[:q]), torch.as_tensor(zs)
    post = _posterior()
    assert post._whiten.W is None and covmat.can_hold_inverse(post.data.L)
    profiling.reset_library_calls()
    with torch.no_grad():
        out = _held(post, xq, zt)
    # one inverse, then six products (cov(x, z) whitens both sides); no
    # substitution and no per-query inverse
    assert profiling.LIBRARY_CALLS["wide_inverse"] == 1
    assert profiling.LIBRARY_CALLS["whiten_cached"] == 6
    assert profiling.LIBRARY_CALLS["tri_solve"] == 0
    assert torch.equal(post._whiten.W, blocked_chol.lower_inverse(post.data.L))

    with torch.no_grad():
        want = _per_query(post, xq, zt)
    mean_scale = float(np.abs(jax_answers["mean"]).max())
    _check(out, want, 1e-5 * mean_scale)
    jax_q = {"mean": jax_answers["mean"][:q], "var": jax_answers["var"][:q],
             "cov": jax_answers["cov"][:q, :q], "cov_z": jax_answers["cov_z"][:q]}
    _check(out, jax_q, 1e-4 * mean_scale)
    # the split TRMM, which a held W takes from _TRMM_RHS columns on, gives
    # the same answers as the one GEMM below it
    _paths.setattr(blocked_chol, "_TRMM_RHS", 1)
    _paths.setattr(blocked_chol, "_TRMM_SPLIT", 32)
    with torch.no_grad():
        _close(post.mean_and_var(xq)[1], out["var"], 1e-5 * S2)
        _close(post.cov(xq, zt), out["cov_z"], 1e-5 * S2)


def test_a_posterior_with_a_graph_keeps_the_per_query_path_and_its_gradient():
    x, y, xs, _ = _data()
    th = [torch.tensor(v, requires_grad=True) for v in (S2, ELL, NOISE)]
    k = th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1])
    post = agt.posterior(agt.GP(k)(torch.as_tensor(x), th[2]), torch.as_tensor(y))
    assert post.data.L.requires_grad and not covmat.can_hold_inverse(post.data.L)
    for q in (8, Q):  # substitution, the wide solve
        xq = torch.as_tensor(xs[:q])
        profiling.reset_library_calls()
        mu, var = post.mean_and_var(xq)
        got = torch.autograd.grad(mu.sum() + var.sum(), th, retain_graph=True)
        assert profiling.LIBRARY_CALLS["whiten_cached"] == 0
        mu, var = _per_query_mean_and_var(post, xq)
        ref = torch.autograd.grad(mu.sum() + var.sum(), th, retain_graph=True)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert post._whiten.W is None


def _per_query_mean_and_var(post, xq):
    out = _per_query(post, xq, xq[:1])
    return out["mean"], out["var"]


def _grad_x(post, xq, predict):
    xq = xq.clone().requires_grad_()
    mu, var = predict(post, xq)
    return _n(torch.autograd.grad(mu.sum() + var.sum(), xq)[0])


@pytest.mark.parametrize("q", QS)
def test_a_gradient_in_the_test_inputs_flows_through_the_held_inverse(q):
    _, _, xs, _ = _data()
    xq = torch.as_tensor(xs[:q])
    post = _posterior()
    with torch.inference_mode():  # W formed here still serves autograd later
        post.mean_and_var(xq)
    got = _grad_x(post, xq, lambda p, x: p.mean_and_var(x))
    assert not post._whiten.W.is_inference() and not post._whiten.W.requires_grad
    per_query = _grad_x(post, xq, _per_query_mean_and_var)
    truth = _grad_x(_posterior(dtype=torch.float64), xq.double(),
                    lambda p, x: p.mean_and_var(x))
    assert np.abs(got - truth).max() <= 2.0 * np.abs(per_query - truth).max()


def test_substitution_solves_keep_the_triangular_solve():
    _, _, xs, _ = _data()
    post = _posterior()
    for q in (1, Q):
        profiling.reset_library_calls()
        with covmat.substitution_solves(), torch.no_grad():
            post.mean_and_var(torch.as_tensor(xs[:q]))
        assert profiling.LIBRARY_CALLS["tri_solve"] == 1
        assert profiling.LIBRARY_CALLS["wide_inverse"] == 0
        assert profiling.LIBRARY_CALLS["whiten_cached"] == 0
    assert post._whiten.W is None


def test_a_sequential_posterior_forms_its_own_inverse():
    x, y, xs, _ = _data()
    xq = torch.as_tensor(xs)
    first = _posterior(100)
    with torch.no_grad():
        first.mean_and_var(xq)
    W1 = first._whiten.W
    assert W1.shape == (100, 100)
    with torch.no_grad():
        seq = agt.posterior(first(torch.as_tensor(x[100:]), NOISE), torch.as_tensor(y[100:]))
        assert seq._whiten.W is None
        got = seq.mean_and_var(xq)
        assert seq._whiten.W.shape == (N, N) and first._whiten.W is W1
        assert torch.equal(seq._whiten.W, blocked_chol.lower_inverse(seq.data.L))
        _close(got[1], _per_query_mean_and_var(seq, xq)[1], 1e-5 * S2)


@pytest.mark.parametrize("case", ["disabled", "f64"])
def test_the_library_path_forms_no_inverse(_paths, case):
    _, _, xs, zs = _data()
    dtype = torch.float64 if case == "f64" else torch.float32
    if case == "disabled":
        _paths.setattr(blocked_chol, "_ENABLED", False)
    post = _posterior(dtype=dtype)
    assert not covmat.can_hold_inverse(post.data.L)
    profiling.reset_library_calls()
    with torch.no_grad():
        for q in (1, Q):
            _held(post, torch.as_tensor(xs[:q], dtype=dtype), torch.as_tensor(zs, dtype=dtype))
    assert post._whiten.W is None
    assert profiling.LIBRARY_CALLS["wide_inverse"] == 0
    assert profiling.LIBRARY_CALLS["whiten_cached"] == 0
