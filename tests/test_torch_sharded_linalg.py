"""The port's tensor-parallel linear algebra
(``abstractgps_tpu_torch.parallel.sharded_linalg``) in a gloo world of four
CPU processes, against the JAX package's functions on a 4-device mesh at
the same block, at f64.

The world (tests/torch_parallel_worker.py ``tp4``) runs every case of
tests/test_sharded_linalg.py (its slow ones too), the gradients of the
logpdf and of the prediction, the collectives of a sweep and the
collectives' own repairs, and writes each rank's results to files; each
check below is a test of its own that reads them. The inputs are drawn
here with numpy, as the JAX tests draw theirs; the world meets through a
file store under ``tmp_path`` and times out after 120 s.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401

import abstractgps_tpu as agp
from abstractgps_tpu.ops.noise import DenseNoise
from abstractgps_tpu.parallel import make_mesh
from abstractgps_tpu.parallel.sharded_linalg import (
    distributed_cholesky,
    sharded_gram,
    sharded_logpdf,
    sharded_mean_and_var,
)

_WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
TIMEOUT = 120
WORLD = 4
THETA = (1.3, 0.7, 0.2, 0.1)  # σ², ℓ, the constant mean, the noise of the ∇ cases


def _spd(rng, n):
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


def _inputs():
    """Each case's inputs, drawn as its JAX test draws them (a fresh
    ``default_rng(42)``)."""
    def rng():
        return np.random.default_rng(42)

    inp = {"chol_A": _spd(rng(), 512), "chol_pad_A": _spd(rng(), 300),
           "gram_x": rng().uniform(size=(256, 3)), "chol_nan_A": np.eye(128)}
    inp["chol_nan_A"][70, 70] = -1.0  # block 4 of 8 is not positive definite
    for n in (512, 300):
        r = rng()
        inp[f"lp{n}_x"], inp[f"lp{n}_y"] = r.uniform(size=(n, 2)), r.normal(size=(n,))
    r = rng()
    inp["lp_diag_x"] = r.uniform(size=(256, 1))
    inp["lp_diag_sig"] = r.uniform(0.05, 0.5, size=(256,))
    inp["lp_diag_y"] = r.normal(size=(256,))
    r = rng()
    inp["lp_mat_x"], inp["lp_mat_Y"] = r.uniform(size=(300, 2)), r.normal(size=(300, 3))
    r = rng()
    inp["rej_x"] = r.uniform(size=(64, 1))
    inp["rej_S"] = _spd(r, 64)
    inp["rej_y"] = r.normal(size=(64,))
    r = rng()
    inp["lp16_x"], inp["lp16_y"] = r.uniform(size=(512, 2)), r.normal(size=(512,))
    r = rng()
    inp["pred_x"], inp["pred_y"] = r.uniform(size=(52, 2)), r.normal(size=(52,))
    inp["pred_xt"] = r.uniform(size=(11, 2))
    r = rng()
    inp["pred_mat_x"], inp["pred_mat_Y"] = r.uniform(size=(48, 2)), r.normal(size=(48, 3))
    inp["pred_mat_xt"] = r.uniform(size=(3000, 2))
    r = np.random.default_rng(3)
    inp["grad_x"], inp["grad_y"] = r.uniform(size=(100, 2)), r.normal(size=(100,))
    inp["gp_x"], inp["gp_y"] = r.uniform(size=(60, 2)), r.normal(size=(60,))
    inp["gp_xt"] = r.uniform(size=(7, 2))
    return inp


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """(inputs, each rank's JSON results, each rank's arrays)."""
    d = str(tmp_path_factory.mktemp("tp"))
    inp = _inputs()
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-u", _WORKER, "tp4", str(r), str(WORLD), d],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out in outs:
        assert rc == 0, f"a rank failed (rc={rc}):\n{out[-4000:]}"
    res, arrs = [], []
    for r in range(WORLD):
        with open(os.path.join(d, f"tp4_rank{r}.json")) as fh:
            res.append(json.load(fh))
        with np.load(os.path.join(d, f"tp4_rank{r}.npz")) as z:
            arrs.append({k: z[k] for k in z.files})
    return inp, res, arrs


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(WORLD, ("tp",))


def _replicated(arrs, key):
    """The value every rank returned, checked bit for bit across ranks."""
    for a in arrs[1:]:
        np.testing.assert_array_equal(a[key], arrs[0][key])
    return arrs[0][key]


# ---------------------------------------------------------------------------
# tests/test_sharded_linalg.py, case by case
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,n", [("chol", 512), ("chol_pad", 300)])
def test_distributed_cholesky_matches_jax(tp, mesh, key, n):
    inp, _, arrs = tp
    A = jnp.asarray(inp[f"{key}_A"])
    got = _replicated(arrs, key)
    assert got.shape == (n, n)
    want = np.asarray(distributed_cholesky(A, mesh, block=64))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got, np.asarray(jnp.linalg.cholesky(A)), rtol=1e-8, atol=1e-8)


def test_distributed_cholesky_of_a_block_that_is_not_pd_gives_nan(tp, mesh):
    # as lax.linalg.cholesky: the failing block and what follows it are NaN,
    # the rows above it as they were
    inp, _, arrs = tp
    got = _replicated(arrs, "chol_nan")
    want = np.asarray(distributed_cholesky(jnp.asarray(inp["chol_nan_A"]), mesh, block=16))
    low = np.tril(np.ones((64, 64), dtype=bool))
    assert np.isnan(got[64:, 64:][low]).all() and np.isnan(want[64:, 64:][low]).all()
    np.testing.assert_array_equal(got[:64], want[:64])


def test_sharded_gram_matches_jax(tp, mesh):
    inp, _, arrs = tp
    x = jnp.asarray(inp["gram_x"])
    k = agp.Matern52Kernel()
    # rank r holds the rows [64r, 64r + 64): shard_along's block
    got = np.concatenate([a["gram"] for a in arrs])
    np.testing.assert_allclose(got, np.asarray(sharded_gram(k, x, mesh)), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(agp.kernelmatrix(k, x)), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [512, 300])
def test_sharded_logpdf_matches_jax(tp, mesh, n):
    inp, _, arrs = tp
    x = jnp.asarray(inp[f"lp{n}_x"])
    f = agp.GP(0.3, 1.5 * agp.with_lengthscale(agp.SqExponentialKernel(), 0.7))
    fx = f(x, 0.1)
    y = jnp.asarray(inp[f"lp{n}_y"]) + 0.3
    got = float(_replicated(arrs, f"lp{n}"))
    np.testing.assert_allclose(got, float(sharded_logpdf(fx, y, mesh, block=64)), rtol=1e-9)
    np.testing.assert_allclose(got, float(fx.logpdf(y)), rtol=1e-9)


def test_sharded_logpdf_diagonal_noise_matches_jax(tp, mesh):
    inp, _, arrs = tp
    fx = agp.GP(agp.Matern32Kernel())(jnp.asarray(inp["lp_diag_x"]),
                                      jnp.asarray(inp["lp_diag_sig"]))
    y = jnp.asarray(inp["lp_diag_y"])
    got = float(_replicated(arrs, "lp_diag"))
    np.testing.assert_allclose(got, float(sharded_logpdf(fx, y, mesh, block=64)), rtol=1e-9)
    np.testing.assert_allclose(got, float(fx.logpdf(y)), rtol=1e-9)


def test_sharded_logpdf_matrix_y_matches_jax(tp, mesh):
    inp, _, arrs = tp
    fx = agp.GP(0.1, agp.Matern52Kernel())(jnp.asarray(inp["lp_mat_x"]), 0.2)
    Y = jnp.asarray(inp["lp_mat_Y"])
    got = _replicated(arrs, "lp_mat")
    assert got.shape == (3,)
    np.testing.assert_allclose(got, np.asarray(sharded_logpdf(fx, Y, mesh, block=64)),
                               rtol=1e-9)
    want = np.asarray([float(fx.logpdf(Y[:, j])) for j in range(3)])
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_sharded_logpdf_rejects_dense_noise(tp, mesh):
    inp, res, _ = tp
    fx = agp.GP(agp.Matern32Kernel())(jnp.asarray(inp["rej_x"]), jnp.asarray(inp["rej_S"]))
    with pytest.raises(NotImplementedError):
        sharded_logpdf(fx, jnp.asarray(inp["rej_y"]), mesh, block=64)
    assert all(r["raises"][0] for r in res)


def test_sharded_logpdf_rejects_bad_y_shape(tp, mesh):
    inp, res, _ = tp
    fx = agp.GP(agp.Matern32Kernel())(jnp.asarray(inp["rej_x"]), 0.1)
    with pytest.raises(ValueError):
        sharded_logpdf(fx, jnp.zeros((65,)), mesh, block=64)
    assert all(r["raises"][1] for r in res)


def test_sharded_logpdf_many_panels_matches_jax(tp, mesh):
    # 32 panels at block 16
    inp, _, arrs = tp
    fx = agp.GP(agp.SqExponentialKernel())(jnp.asarray(inp["lp16_x"]), 0.1)
    y = jnp.asarray(inp["lp16_y"])
    got = float(_replicated(arrs, "lp16"))
    np.testing.assert_allclose(got, float(sharded_logpdf(fx, y, mesh, block=16)), rtol=1e-9)
    np.testing.assert_allclose(got, float(fx.logpdf(y)), rtol=1e-9)


def test_sharded_mean_and_var_matches_jax(tp, mesh):
    inp, _, arrs = tp
    fx = agp.GP(0.4, agp.Matern52Kernel())(jnp.asarray(inp["pred_x"]), 0.1)
    y, xt = jnp.asarray(inp["pred_y"]), jnp.asarray(inp["pred_xt"])
    mu, var = _replicated(arrs, "pred_mean"), _replicated(arrs, "pred_var")
    mu_j, var_j = sharded_mean_and_var(fx, y, xt, mesh, block=8)
    mu_d, var_d = fx.posterior(y).mean_and_var(xt)
    for want_mu, want_var in ((mu_j, var_j), (mu_d, var_d)):
        np.testing.assert_allclose(mu, np.asarray(want_mu), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(var, np.asarray(want_var), rtol=1e-7, atol=1e-8)


def test_sharded_mean_and_var_rejects_dense_noise(tp):
    _, res, _ = tp
    x = jnp.asarray(np.random.default_rng(42).uniform(size=(16, 1)), jnp.float32)
    fx = agp.GP(agp.Matern32Kernel())(x, DenseNoise(0.1 * jnp.eye(16, dtype=jnp.float32)))
    with pytest.raises(NotImplementedError):
        sharded_mean_and_var(fx, jnp.zeros(16), x[:4], make_mesh(8, ("tp",)))
    assert all(r["raises"][2] for r in res)


def test_sharded_mean_and_var_matrix_y_and_chunking_matches_jax(tp, mesh):
    # M = 3000 at test_chunk 1024: three sweeps
    inp, _, arrs = tp
    fx = agp.GP(0.4, agp.Matern52Kernel())(jnp.asarray(inp["pred_mat_x"]), 0.1)
    Y, xt = jnp.asarray(inp["pred_mat_Y"]), jnp.asarray(inp["pred_mat_xt"])
    mu, var = _replicated(arrs, "pred_mat_mean"), _replicated(arrs, "pred_mat_var")
    assert mu.shape == (3000, 3) and var.shape == (3000,)
    mu_j, var_j = sharded_mean_and_var(fx, Y, xt, mesh, block=8, test_chunk=1024)
    np.testing.assert_allclose(mu, np.asarray(mu_j), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(var, np.asarray(var_j), rtol=1e-7, atol=1e-8)
    for j in range(3):
        mu_d, var_d = fx.posterior(Y[:, j]).mean_and_var(xt)
        np.testing.assert_allclose(mu[:, j], np.asarray(mu_d), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(var, np.asarray(var_d), rtol=1e-7, atol=1e-8)


# ---------------------------------------------------------------------------
# the gradient rule: every rank seeds its copy and gets jax.grad
# ---------------------------------------------------------------------------


def _jax_fx(s2, ell, c, noise, x):
    return agp.GP(c, s2 * agp.with_lengthscale(agp.Matern52Kernel(), ell))(x, noise)


def _check_grads(arrs, prefix, names, want):
    for a in arrs:
        for k, w in zip(names, want):
            np.testing.assert_allclose(a[f"{prefix}_{k}"], np.asarray(w), rtol=1e-8,
                                       atol=1e-8 * float(np.max(np.abs(w))), err_msg=k)


def test_sharded_logpdf_gradient_matches_jax_grad_on_every_rank(tp, mesh):
    # N = 100 at block 16 over 4 ranks: 128 padded rows, 8 panels
    inp, _, arrs = tp
    x, y = jnp.asarray(inp["grad_x"]), jnp.asarray(inp["grad_y"])

    def lp(s2, ell, c, noise, x_, y_):
        return sharded_logpdf(_jax_fx(s2, ell, c, noise, x_), y_, mesh, block=16)

    want = jax.grad(lp, argnums=tuple(range(6)))(*THETA, x, y)
    np.testing.assert_allclose(float(_replicated(arrs, "grad_value")),
                               float(lp(*THETA, x, y)), rtol=1e-9)
    _check_grads(arrs, "grad", ("s2", "ell", "c", "noise", "x", "y"), want)


def test_sharded_mean_and_var_gradient_matches_jax_grad_on_every_rank(tp, mesh):
    inp, _, arrs = tp
    x, y, xt = (jnp.asarray(inp[k]) for k in ("gp_x", "gp_y", "gp_xt"))

    def loss(s2, ell, c, noise, x_, y_, xt_):
        m, v = sharded_mean_and_var(_jax_fx(s2, ell, c, noise, x_), y_, xt_, mesh, block=8)
        return m.sum() + v.sum()

    want = jax.grad(loss, argnums=tuple(range(7)))(*THETA, x, y, xt)
    _check_grads(arrs, "gp", ("s2", "ell", "c", "noise", "x", "y", "xt"), want)


# ---------------------------------------------------------------------------
# the sweep's collectives (the counterpart of tests/test_scaling_structure.py's
# HLO bound: one all-gather and at most two other collectives a panel)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,panels", [("lp16", 32), ("pred", 8)])
def test_sweep_collectives_per_panel(tp, key, panels):
    # logpdf: N = 512 at block 16; prediction: N = 52 → 64 rows at block 8.
    # A panel sends the owner's block (one broadcast) and gathers the panel
    # column (one all_gather); the last panel has no rows below it to gather
    _, res, _ = tp
    for r in res:
        c = r[f"{key}_counts"]
        assert c["layer"] == {"all_reduce": 0, "all_gather": panels - 1, "broadcast": panels}
        assert sum(c["raw"].values()) == 2 * panels - 1
        assert c["raw"]["all_gather"] == panels - 1 and c["raw"]["broadcast"] == panels


def test_sweep_gradient_collectives(tp):
    # N = 100 at block 16: 8 panels forward; the backward adds one all-reduce
    # for each collective of the forward and one for the replicated inputs
    _, res, _ = tp
    for r in res:
        assert r["grad_fwd_counts"]["layer"] == {"all_reduce": 0, "all_gather": 7,
                                                 "broadcast": 8}
        assert r["grad_bwd_counts"]["layer"] == {"all_reduce": 16, "all_gather": 0,
                                                 "broadcast": 0}
        assert r["grad_bwd_counts"]["raw"]["all_reduce"] == 16
        assert sum(r["grad_bwd_counts"]["raw"].values()) == 16


def test_gathered_panel_bytes(tp):
    # each rank sends its trailing rows, padded to the longest rank's: at
    # panel k, 512 − 16·(k+1) rows in all, (nb_local − (k+1)//4)·16 a rank
    _, res, _ = tp
    gathered = sum((32 // WORLD - (k + 1) // WORLD) * 16 * 16 * 8 for k in range(31))
    for r in res:
        assert r["lp16_bytes"]["all_gather"] == gathered
        # the owner's diagonal block and its right-hand-side row block
        assert r["lp16_bytes"]["broadcast"] == 32 * 16 * 17 * 8


# ---------------------------------------------------------------------------
# parallel/collectives.py: broadcast from a chosen source; differentiable
# all_gather and broadcast_from
# ---------------------------------------------------------------------------


def test_broadcast_from_a_chosen_source(tp):
    _, res, _ = tp
    for r in res:
        assert r["broadcast_src2"] == [2.0, 2.0, 2.0]


def test_all_gather_backward_sums_the_ranks_cotangents(tp):
    # rank r gathers a full (2, 2) of r + 1 and seeds Σ gathered·w·(r + 1):
    # its block's gradient is Σ_r' (r' + 1)·w[its rows] = 10·w[its rows]
    _, res, _ = tp
    w = np.arange(16.0).reshape(8, 2)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["all_gather_grad"], 10.0 * w[2 * r:2 * r + 2])


def test_broadcast_from_backward_reaches_the_source_only(tp):
    _, res, _ = tp
    for r, out in enumerate(res):
        got, grad = out["broadcast_from"]
        assert got == [4.0, 4.0]
        assert grad == ([10.0, 10.0] if r == 3 else None)
