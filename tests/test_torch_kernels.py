"""The port's kernel-holding functions against the JAX package's Pallas
kernels, run as the JAX package's own tests run them (interpret mode on
the CPU), at small sizes and f32.

On the CPU every wrapper of ``abstractgps_tpu_torch`` takes its kernel's
plain torch version, so these tests hold the kernels' arithmetic and the
sweeps around them; tests/test_torch_cuda.py holds the CUDA kernels against
the same plain versions on a card.

Tolerances: f32 results agree to ~1e-5 relative (the JAX package's own
pallas-vs-lax bound, tests/test_pallas_kernels.py:259); entries near zero
get an absolute floor of the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import kernel_tree, small_kernel_paths, spd

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu.ops import pallas_chol, pallas_gram
from abstractgps_tpu_torch.ops import blocked_chol, covmat, fused_gram

F32 = dict(rtol=1e-5, atol=2e-6)


@pytest.fixture(autouse=True)
def _small_paths():
    with small_kernel_paths() as mp:
        yield mp


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# the seven isotropic families of the gram tile, JAX side (f32 hypers)
FAMILIES = [
    (0, lambda: agp.SEKernel()),
    (1, lambda: agp.ExponentialKernel()),
    (2, lambda: agp.Matern32Kernel()),
    (3, lambda: agp.Matern52Kernel()),
    (4, lambda: agp.RationalQuadraticKernel(alpha=jnp.float32(1.5))),
    (5, lambda: agp.GammaExponentialKernel(gamma=jnp.float32(1.3))),
    (6, lambda: agp.CosineKernel()),
]


@pytest.mark.parametrize("family,make", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_gram_tile_matches_pallas(rng, family, make):
    x = rng.uniform(size=(70, 3)).astype(np.float32)
    z = rng.uniform(size=(50, 3)).astype(np.float32)
    kj = make()
    kt = agt.kernel_from_numpy(kernel_tree(kj), dtype=torch.float32)
    assert kt.FAMILY == family
    params = kt._map_params()
    for symmetric, zz in ((False, z), (True, x)):
        want = pallas_gram._fused_fwd_impl(symmetric, kj, jnp.asarray(x), jnp.asarray(zz))
        got = fused_gram.gram_tile(_t(x), _t(zz), family, params, symmetric)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
        if symmetric:
            assert np.all(np.diagonal(got.detach().numpy()) == np.asarray(kj._apply_sqdist(0.0)))
    # the routed entry point: the stationary kernel's cross through the gate
    assert fused_gram.should_use_kernel(_t(x), _t(z))
    np.testing.assert_allclose(kt.cross(_t(x), _t(z)).detach().numpy(),
                               np.asarray(kj.cross(jnp.asarray(x), jnp.asarray(z))), **F32)


@pytest.mark.parametrize("B", [32, 64])
def test_chol_inv_block_matches_pallas(rng, B):
    A = spd(rng, B).astype(np.float32)
    Lt, W = pallas_chol._chol_inv_block(jnp.asarray(A), interpret=True)
    # garbage in the upper triangle must not enter (lower triangle read)
    dirty = np.tril(A) + np.triu(rng.normal(size=(B, B)) * 1e3, 1).astype(np.float32)
    L_t, W_t = blocked_chol.chol_inv_block(_t(dirty))
    np.testing.assert_allclose(L_t.detach().numpy(), np.asarray(Lt).T, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(W_t.detach().numpy(), np.asarray(W), rtol=1e-5, atol=1e-5)
    assert np.all(np.triu(L_t.detach().numpy(), 1) == 0) and np.all(np.triu(W_t.detach().numpy(), 1) == 0)
    bad = A - 10.0 * np.eye(B, dtype=np.float32)
    assert torch.isnan(blocked_chol.chol_inv_block(_t(bad))[0]).any()


@pytest.mark.parametrize("B", [32, 64])
def test_chol_block_matches_pallas(rng, B):
    A = spd(rng, B).astype(np.float32)
    # garbage in the upper triangle must not enter either version
    dirty = np.tril(A) + np.triu(rng.normal(size=(B, B)) * 1e3, 1).astype(np.float32)
    want = pallas_chol._chol_block(jnp.asarray(dirty, jnp.float32), interpret=True)
    got = blocked_chol.chol_block(_t(dirty))
    assert got.dtype == torch.float32 and got.shape == (B, B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert np.all(np.triu(got.numpy(), 1) == 0)
    # chol_inv_block's factor half is the same column-step code
    assert torch.equal(blocked_chol.chol_inv_block_plain(_t(dirty))[0], got)
    bad = A - 10.0 * np.eye(B, dtype=np.float32)
    assert np.isnan(np.asarray(pallas_chol._chol_block(jnp.asarray(bad), interpret=True))).any()
    L_bad = blocked_chol.chol_block(_t(bad))
    assert torch.isnan(L_bad).any() and np.all(np.triu(L_bad.numpy(), 1) == 0)


def test_slab_factor_matches_pallas_and_f64(rng):
    W_, B = 64, 16
    S = spd(rng, W_)
    Lt, Ws = pallas_chol._slab_factor(jnp.asarray(S, jnp.float32), interpret=True)
    L_t, Ws_t = blocked_chol.slab_factor(_t(S), B)
    np.testing.assert_allclose(L_t.detach().numpy(), np.asarray(Lt).T, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Ws_t.detach().numpy(), np.asarray(Ws), rtol=1e-5, atol=1e-5)
    # the slab path against an f64 Cholesky (the interpret-mode _sdot is not
    # the TPU's bf16 split, so the JAX output alone is not the oracle)
    L64 = np.linalg.cholesky(S)
    np.testing.assert_allclose(L_t.detach().numpy(), L64, rtol=1e-5, atol=1e-5)
    for k in range(W_ // B):
        blk = L64[k * B:(k + 1) * B, k * B:(k + 1) * B]
        np.testing.assert_allclose(Ws_t[k].detach().numpy(), np.linalg.inv(blk), rtol=1e-5, atol=1e-5)


def test_tri_inv_block_matches_pallas(rng):
    n, B = 64, 16
    L = np.linalg.cholesky(spd(rng, n)).astype(np.float32)
    want = pallas_chol._batched_diag_inv(jnp.asarray(L), B)
    got = blocked_chol.tri_inv_block(_t(L), B)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    one = pallas_chol._pallas_diag_inv(jnp.asarray(L[16:32, 16:32]))
    one_t = blocked_chol.tri_inv_block(_t(L)[16:32, 16:32], B)[0]
    np.testing.assert_allclose(one_t.detach().numpy(), np.asarray(one), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [80, 128])
def test_lower_inverse_matches_pallas(rng, n, _small_paths):
    # n = 80: five 16-wide blocks, the row-panel trtri; n = 128: eight, the
    # doubling merges. Either way the diagonal blocks come from ONE batched
    # tri_inv_block call
    L = np.linalg.cholesky(spd(rng, n)).astype(np.float32)
    want = np.asarray(pallas_chol._inv_lower_blocked(jnp.asarray(L), 16))
    calls = []
    tri_inv_block = blocked_chol.tri_inv_block
    _small_paths.setattr(blocked_chol, "tri_inv_block",
                         lambda *a: calls.append(a[1]) or tri_inv_block(*a))
    got = blocked_chol.lower_inverse(_t(L)).detach().numpy()
    assert calls == [16]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,m", [(8192, 8192), (8192, 4096), (4096, 8192), (1000, 700),
                                 (64, 64), (100, 1), (200000, 300)])
def test_gram_bwd_column_splits_cover_each_tile_once(n, m):
    # gram_bwd's grid: S column splits of the ⌈m/64⌉ tiles, fixed by (n, m)
    # alone (the signature takes nothing else), so the same shapes always
    # sum their partials in the same order; csrc/gram_bwd.cu gives split s
    # the tiles [s·T // S, (s+1)·T // S), which cover each tile once for
    # any 1 ≤ S ≤ T
    S = fused_gram.column_split_count(n, m)
    tiles, rows = -(-m // 64), -(-n // 64)
    assert isinstance(S, int) and 1 <= S <= tiles
    ranges = [(s * tiles // S, (s + 1) * tiles // S) for s in range(S)]
    assert [t for t0, t1 in ranges for t in range(t0, t1)] == list(range(tiles))
    assert all(t1 > t0 for t0, t1 in ranges)
    # at least ~4 CTAs per SM of 132, unless every tile is a split already
    assert S == tiles or rows * S >= 4 * 132
    assert S == 1 or rows * (S - 1) < 8 * 132


@pytest.mark.parametrize("n", [150, 128])
def test_cholesky_gram_with_carried_rhs(rng, n, _small_paths):
    # n=150: two 64-wide slabs through the slab path + a 32-wide tail slab
    # through the per-block path (npad = 160); n=128: slabs only
    x = rng.uniform(size=(n, 2)).astype(np.float32)
    nd = rng.uniform(0.1, 0.3, size=(n,)).astype(np.float32)
    rhs = rng.normal(size=(n, 3)).astype(np.float32)
    kj = jnp.float32(1.3) * agp.with_lengthscale(agp.Matern32Kernel(), jnp.float32(0.7))
    kt = agt.kernel_from_numpy(kernel_tree(kj), dtype=torch.float32)
    Lj, Zj = pallas_chol._cholesky_gram_impl(kj, jnp.asarray(x), jnp.asarray(nd), 16,
                                             rhs=jnp.asarray(rhs))
    L_t, Z_t = blocked_chol._cholesky_gram_impl(kt, _t(x), _t(nd), 16, rhs=_t(rhs))
    np.testing.assert_allclose(L_t.detach().numpy(), np.asarray(Lj), rtol=2e-5, atol=2e-5)
    # Z = L⁻¹ rhs carries the f32 solve error, ~κ·eps of its largest entry
    np.testing.assert_allclose(Z_t.detach().numpy(), np.asarray(Zj), rtol=2e-5,
                               atol=2e-5 * np.abs(np.asarray(Zj)).max())
    # the public entry point and the fused logpdf agree with it
    np.testing.assert_allclose(blocked_chol.cholesky_gram(kt, _t(x), _t(nd)).detach().numpy(),
                               L_t.detach().numpy(), rtol=0, atol=0)
    # the slab path against the per-block path (every block through
    # chol_inv_block: an outer width above npad leaves no full slab), both
    # in f32
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocked_chol, "_OUTER", 256)
        L_b, Z_b = blocked_chol._cholesky_gram_impl(kt, _t(x), _t(nd), 16, rhs=_t(rhs))
    np.testing.assert_allclose(L_b.detach().numpy(), L_t.detach().numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(Z_b.detach().numpy(), Z_t.detach().numpy(), rtol=2e-5,
                               atol=2e-5 * np.abs(np.asarray(Zj)).max())
    lp = blocked_chol.gram_logpdf_core(kt, _t(x), _t(nd), _t(rhs))
    lp_j = pallas_chol.gram_logpdf_core(kj, jnp.asarray(x), jnp.asarray(nd), jnp.asarray(rhs))
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(lp_j), rtol=1e-5)
    # the logpdf from an assembled factor agrees with the sweep's
    lp_chol = blocked_chol._logpdf_from_chol(L_t, _t(rhs))
    np.testing.assert_allclose(lp_chol.detach().numpy(),
                               np.asarray(pallas_chol._logpdf_from_chol(Lj, jnp.asarray(rhs))),
                               rtol=1e-5)


def test_blocked_cholesky_matches_pallas(rng):
    # pallas_cholesky reads from A (not a built gram), pad 200 → 208
    A = spd(rng, 200).astype(np.float32)
    want = pallas_chol.pallas_cholesky(jnp.asarray(A))
    assert blocked_chol.should_use_pallas(_t(A))
    got = agt.ops.covmat.cholesky_lower(_t(np.tril(A)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n,m", [(128, 33), (96, 20), (200, 17)])
def test_wide_solves_match_pallas(rng, n, m, _small_paths):
    # n=128: nb = 8, doubling trtri over the batched block inverses;
    # n=96 (nb = 6) and n=200 (padded, nb = 13): the row-panel fallback
    L = np.linalg.cholesky(spd(rng, n)).astype(np.float32)
    B = rng.normal(size=(n, m)).astype(np.float32)
    Lj, Bj = jnp.asarray(L), jnp.asarray(B)
    assert covmat._wide_rhs(_t(L), _t(B))
    for port, ref in ((blocked_chol.solve_lower_wide, pallas_chol.solve_lower_wide),
                      (blocked_chol.solve_upper_wide, pallas_chol.solve_upper_wide),
                      (blocked_chol.chol_solve_wide, pallas_chol.chol_solve_wide)):
        want = np.asarray(ref(Lj, Bj))
        got = port(_t(L), _t(B)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
        # the split TRMMs (taken at full size, from _TRMM_SPLIT rows and
        # _TRMM_RHS columns) give the same product as the unsplit ones
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(blocked_chol, "_TRMM_SPLIT", 32)
            mp.setattr(blocked_chol, "_TRMM_RHS", 1)
            split = port(_t(L), _t(B)).detach().numpy()
        np.testing.assert_allclose(split, got, rtol=1e-5, atol=1e-5 * np.abs(want).max())
