"""Three repairs of the port, held against the JAX package on the CPU at
N = 1024 with both packages' Pallas paths in interpret mode (the fused paths
at their default sizes) and against f64 autograd.

- A deep kernel, ``σ²·(SE∘ℓ)∘FunctionTransform(mlp)`` with the MLP of
  ``examples/deep_kernel_learning.py`` (1 → 16 → 16 → 2, tanh), whose
  parameter tree is a list of ``{"w", "b"}`` dicts (or a tuple, or a nested
  dict): every leaf's gradient through ``gram_logpdf_core`` (the logpdf) and
  through ``cholesky_gram`` (the posterior's ``mean_and_var``), beside
  ``jax.grad`` of the JAX package at f32 and at f64.
- The Cholesky pullback by triangular substitution, as the JAX package's:
  Ā of ``pallas_cholesky`` for a σ²·Matérn-3/2 gram at noise 0.1 and 1e-3,
  and ℓ's gradient ⟨Ā, ∂K/∂ℓ⟩, against their f64 truth, beside the JAX
  package's own f32 errors. (The gradient of a whole prediction carries the
  f32 forward's rounding, which sets its error there, not the pullback.)
- The fused gram's squared distances on inputs far from the origin (a 1-D
  time axis): the kernels and their plain versions form d² from the
  differences, where ‖x‖² + ‖z‖² − 2x·z rounds to eps·‖x‖². The f32
  logpdf and its gradient through the fused paths against f64 autograd.

The JAX sides, which take seconds in interpret mode, are computed once per
module.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from torch_port_helpers import mlp_apply, mlp_trees, mlp_weights

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu.ops import pallas_chol, pallas_gram
from abstractgps_tpu_torch.ops import blocked_chol, distance, fused_gram

N = 1024


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


@contextlib.contextmanager
def interpret_paths():
    """Both packages' kernel paths in interpret mode at their default sizes,
    so N = 1024 takes the fused paths. The JAX package factors its slab block
    by block (``_SLAB = False``, its own per-block path): the same
    factorization, without the minute that interpret mode takes to compile
    its 1024-wide slab kernel."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))
        for mod in (pallas_chol, pallas_gram, blocked_chol, fused_gram):
            mp.setattr(mod, "_INTERPRET", True)
        mp.setattr(pallas_chol, "_SLAB", False)
        yield mp


def _n(t):
    return t.detach().cpu().numpy()


def _kappa_tol(s2, noise):
    """10·κ·eps32 with κ(K + noise·I) ≤ (N·σ² + noise)/noise: the
    first-order rounding of an f32 factor, inverse and contraction."""
    return 10.0 * (N * s2 + noise) / noise * 2.0 ** -24


# ---------------------------------------------------------------------------
# Fault 1: a deep kernel's parameter tree reaches the fused paths' backwards
# ---------------------------------------------------------------------------

# per path: the logpdf at noise 0.1; the prediction, whose Σvar cancels, at
# noise 1.0, where f32 keeps three digits of its gradient
DEEP_THETA = {"logpdf": {"s2": 1.2, "ell": 0.8, "noise": 0.1},
              "posterior": {"s2": 1.2, "ell": 0.8, "noise": 1.0}}


def _deep_data():
    rng = np.random.default_rng(23)
    x = np.sort(rng.uniform(-5.0, 5.0, size=N))[:, None]
    y = np.sinc(x[:, 0]) + 0.1 * rng.normal(size=N)
    xs = np.linspace(-5.0, 5.0, 64)[:, None]
    return x, y, xs, mlp_weights(rng)


def _deep_out(pkg, ft, th, x, y, xs, path):
    """The logpdf, or Σmean + Σvar of the posterior at xs, of the deep kernel
    in ``pkg`` (either package: the two share these names)."""
    kernel = th["s2"] * pkg.compose(pkg.with_lengthscale(pkg.SEKernel(), th["ell"]), ft)
    fx = pkg.GP(kernel)(x, th["noise"])
    if path == "logpdf":
        return fx.logpdf(y)
    mu, var = pkg.posterior(fx, y).mean_and_var(xs)
    return mu.sum() + var.sum()


def _flat(g_th, g_mlp):
    """σ², ℓ, noise, then each layer's b and w (the order of ``params.leaves``:
    dict keys sorted)."""
    return [np.asarray(g, np.float64) for g in (
        g_th["s2"], g_th["ell"], g_th["noise"],
        *[g for layer in g_mlp for g in (layer["b"], layer["w"])])]


@pytest.fixture(scope="module")
def jax_deep():
    """Per path: jax.grad of the logpdf or of Σmean + Σvar with respect to
    σ², ℓ, the noise and the MLP's tree, at f32 on the fused path
    (interpret mode) and at f64 on the dense path (the truth)."""
    x, y, xs, weights = _deep_data()
    out = {}
    for path, theta in DEEP_THETA.items():
        def f(th_, mlp_, dtype):
            ft = agp.FunctionTransform(mlp_, mlp_apply)
            return _deep_out(agp, ft, th_, *(jnp.asarray(a, dtype) for a in (x, y, xs)), path)

        with interpret_paths():
            g32 = jax.grad(f, argnums=(0, 1))({k: jnp.float32(v) for k, v in theta.items()},
                                              mlp_trees(weights)[0], jnp.float32)
        g64 = jax.grad(f, argnums=(0, 1))(dict(theta), mlp_trees(weights, np.float64)[0],
                                          jnp.float64)
        out[path] = _flat(*g32), _flat(*g64)
    return out


def _as_tree(mlp, layout):
    """The torch MLP list in another container layout, and the feature map
    that reads it."""
    if layout == "list":
        return mlp, mlp_apply
    if layout == "tuple":
        return tuple(mlp), mlp_apply
    return {"hidden": {"layers": list(mlp[:-1])}, "out": mlp[-1]}, (
        lambda p, x_: mlp_apply([*p["hidden"]["layers"], p["out"]], x_))


@pytest.mark.parametrize("path,layout", [("logpdf", "list"), ("posterior", "list"),
                                         ("logpdf", "tuple"), ("logpdf", "dict")])
def test_deep_kernel_grads_match_jax(jax_deep, path, layout):
    # Every leaf's gradient reaches the caller, and each is as close to the
    # f64 truth as the JAX package's f32 gradient on the same inputs: its
    # error (the largest entry's, relative to the leaf's largest f64 entry)
    # at most twice the JAX package's, or within the first-order f32 bound
    # 10·κ·eps (the measured errors: ≲ 2e-4 for the logpdf, ≲ 4e-4 for the
    # prediction). The output bias's exact gradient is 0 (the kernel is
    # stationary: one shift of every feature changes no distance), so its
    # error is taken relative to the output weight's.
    g32_j, g64 = jax_deep[path]
    theta = DEEP_THETA[path]
    x, y, xs, weights = _deep_data()
    _, mlp_t = mlp_trees(weights)
    tree, fn = _as_tree(mlp_t, layout)
    th = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True) for k, v in theta.items()}
    calls = []
    with interpret_paths() as mp:
        orig = fused_gram.logpdf_contraction
        mp.setattr(fused_gram, "logpdf_contraction", lambda *a: calls.append(1) or orig(*a))
        ft = agt.FunctionTransform(tree, fn)
        leaves = [t for layer in mlp_t for t in (layer["b"], layer["w"])]
        assert all(any(t is h for h in agt.kernels.base.hyperparameters(ft)) for t in leaves)
        out = _deep_out(agt, ft, th, *(torch.as_tensor(a, dtype=torch.float32)
                                       for a in (x, y, xs)), path)
        assert out.requires_grad
        got = torch.autograd.grad(out, [th["s2"], th["ell"], th["noise"], *leaves])
    assert bool(calls) == (path == "logpdf")  # the logpdf took the contraction kernel
    tol = _kappa_tol(theta["s2"], theta["noise"])
    out_bias = len(g64) - 2  # the output layer's b; its w comes last
    for i, (g, gj, w) in enumerate(zip(got, g32_j, g64)):
        scale = np.abs(g64[-1] if i == out_bias else w).max()
        err, err_j = np.abs(_n(g) - w).max() / scale, np.abs(gj - w).max() / scale
        assert err <= max(2.0 * err_j, tol), (i, err, err_j, tol)


# ---------------------------------------------------------------------------
# Fault 2: the Cholesky pullback by substitution
# ---------------------------------------------------------------------------


def _pullback_f64(L, Lbar):
    """Ā = sym(L⁻ᵀ Φ(Lᵀ L̄) L⁻¹) in f64 by scipy's triangular solves: the truth
    for a given f32 factor."""
    L, Lbar = L.astype(np.float64), np.tril(Lbar.astype(np.float64))
    M = L.T @ Lbar
    P = np.tril(M, -1) + 0.5 * np.diag(np.diag(M))
    Y = scipy.linalg.solve_triangular(L.T, P, lower=False)
    Abar = scipy.linalg.solve_triangular(L.T, Y.T, lower=False).T
    return 0.5 * (Abar + Abar.T)


@pytest.fixture(scope="module")
def chol_pullback_inputs():
    """Per noise level: an f32 σ²·Matérn-3/2 gram + noise·I (N = 1024, D = 2,
    ℓ = 0.5), a cotangent L̄, ∂K/∂ℓ in f64, and the JAX package's f32
    pullback from its own factor (``jax.vjp`` of ``pallas_cholesky`` in
    interpret mode) with its errors against the f64 truth: Ā's, and that of
    ℓ's gradient ⟨Ā, ∂K/∂ℓ⟩."""
    rng = np.random.default_rng(31)
    x = rng.uniform(size=(N, 2))
    s2, ell = 1.1, 0.5
    k = s2 * agp.with_lengthscale(agp.Matern32Kernel(), ell)
    K = np.asarray(agp.kernelmatrix(k, jnp.asarray(x)))
    r = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    dK = s2 * 3.0 * r ** 2 / ell ** 3 * np.exp(-np.sqrt(3.0) * r / ell)
    out = {}
    for noise in (0.1, 1e-3):
        A = (K + noise * np.eye(N)).astype(np.float32)
        Lbar = np.tril(rng.normal(size=(N, N))).astype(np.float32)
        with interpret_paths():
            L_j, vjp = jax.vjp(pallas_chol.pallas_cholesky, jnp.asarray(A))
            Abar_j = np.asarray(vjp(jnp.asarray(Lbar))[0], np.float64)
        truth = _pullback_f64(np.asarray(L_j), Lbar)
        out[noise] = (A, Lbar, dK, _rel_lower(Abar_j, truth), _rel_ell(Abar_j, truth, dK))
    return out


def _rel_ell(got, want, dK):
    """Error of ℓ's gradient ⟨Ā, ∂K/∂ℓ⟩, relative to the truth's."""
    return abs(np.sum((got - want) * dK)) / abs(np.sum(want * dK))


def _rel_lower(got, want):
    """Frobenius error of the lower triangle, relative to the truth's."""
    return np.linalg.norm(np.tril(got - want)) / np.linalg.norm(np.tril(want))


@pytest.mark.parametrize("noise", [0.1, 1e-3])
def test_chol_pullback_by_substitution(chol_pullback_inputs, noise):
    # The pullback of pallas_cholesky (and of cholesky_gram, which shares
    # it) solves with the factor and forms no inverse: the trtri is not
    # called during the backward. Each package pulls the same L̄ back from
    # its own f32 factor; the port's Ā is held against the f64 truth for its
    # factor at twice the JAX package's own error (same rule, two
    # triangular solves; measured within 0.97 of it, ~1e-6 relative at
    # noise 1e-3, κ ≈ 1e6), and so is ℓ's gradient ⟨Ā, ∂K/∂ℓ⟩, which must
    # also be within 1e-2 of its truth at either noise
    A, Lbar, dK, err_j, err_ell_j = chol_pullback_inputs[noise]
    with interpret_paths() as mp:
        At = torch.as_tensor(A).requires_grad_()
        L = blocked_chol.pallas_cholesky(At)

        def no_inverse(*_):
            raise AssertionError("the pullback formed an explicit inverse")

        mp.setattr(blocked_chol, "lower_inverse", no_inverse)
        (Abar,) = torch.autograd.grad(L, At, torch.as_tensor(Lbar))
    Abar, truth = _n(Abar).astype(np.float64), _pullback_f64(_n(L), Lbar)
    err = _rel_lower(Abar, truth)
    assert err <= 2.0 * err_j, (err, err_j)
    err_ell = _rel_ell(Abar, truth, dK)
    assert err_ell <= max(2.0 * err_ell_j, 1e-5) and err_ell < 1e-2, (err_ell, err_ell_j)


# ---------------------------------------------------------------------------
# Fault 3: d² of the fused paths far from the origin
# ---------------------------------------------------------------------------


def test_fused_paths_hold_f32_accuracy_far_from_the_origin():
    # N = 1024 times over [75, 100] (σ²·Matérn-3/2, ℓ = 0.5, noise 0.1: the
    # density of a Markov validation run, 41 points a unit). With d² formed
    # as ‖x‖² + ‖z‖² − 2x·z the scaled inputs' norms (~4e4) round d² by
    # ~1e-2, and the fused f32 logpdf erred 1.1e-2 relative, its gradient
    # 150 % (σ²), 66 % (ℓ) and 5.5 % (noise) (the f64 side takes the unfused
    # path). From the differences, every result is within 10·κ·eps of f64,
    # κ ≤ (N·σ² + noise)/noise.
    rng = np.random.default_rng(31)
    t = np.sort(rng.uniform(75.0, 100.0, size=N))
    y = rng.normal(size=N)

    def value_and_grad(dtype):
        th = [torch.tensor(v, dtype=dtype, requires_grad=True) for v in (1.0, 0.5, 0.1)]
        k = th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1])
        lp = agt.GP(k)(torch.as_tensor(t, dtype=dtype), th[2]).logpdf(
            torch.as_tensor(y, dtype=dtype))
        return np.array([float(lp.detach())] + [float(g) for g in torch.autograd.grad(lp, th)])

    with interpret_paths():
        got = value_and_grad(torch.float32)
    want = value_and_grad(torch.float64)
    rel = np.abs(got - want) / np.abs(want)
    assert np.all(rel <= _kappa_tol(1.0, 0.1)), (rel, _kappa_tol(1.0, 0.1))
    # the tile itself: every entry within 8·eps of the f64 map of the same
    # f32 inputs (|dg/dd²| ≤ 1.5 and d² rounds to ~2·eps·d²)
    x = torch.as_tensor(2.0 * t[:, None], dtype=torch.float32)
    K = fused_gram.gram_tile_plain(x, x, 2, fused_gram._params_buffer((), x.device), True)
    x64 = _n(x).astype(np.float64)[:, 0]
    d = np.abs(x64[:, None] - x64[None, :]) * np.sqrt(3.0)
    assert np.abs(_n(K) - (1.0 + d) * np.exp(-d)).max() <= 8 * 2.0 ** -24
