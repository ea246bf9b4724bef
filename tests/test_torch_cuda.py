"""The port's hand-written CUDA kernels against their plain torch versions,
on a card. Every test here is marked ``gpu`` and skips where no CUDA device
is present (decided in the ``cuda`` fixture, never at import).

This file imports neither JAX nor the JAX package and needs none of the
suite's conftest, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Tolerances: the kernel and its plain version run the same algorithm in f32
with sums in another order, so they differ by rounding, ~κ·eps of the
largest entry; the SPD inputs here have κ ≲ 40, and 1e-4 of the largest
entry bounds that with room. The slice and gradient tests hold the f32
kernel paths against f64 ``torch.linalg`` oracles on the same card at
10·κ·eps. The backward kernels (``gram_bwd``, ``logpdf_contraction``) must
also return the same bits on a second call.
"""

import copy
import math

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import abstractgps_tpu_torch as agt
from abstractgps_tpu_torch.ops import blocked_chol, cuda as cuda_ops, fused_gram, precision
from abstractgps_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

EPS32 = 2.0 ** -24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_ops.library()  # build (or reuse) the kernels before any timing-free check
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(11)


def _spd(gen, n, device):
    X = gen.normal(size=(n, n + 8))
    A = X @ X.T / (n + 8) + 0.5 * np.eye(n)
    return torch.as_tensor(A, dtype=torch.float32, device=device)


def _close(got, want, rel=1e-4):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale, (err, scale)


def _matern_gram(gen, n, ell, device):
    """K + 0.1·I for a Matérn-3/2 gram of n points in [0, 1]^8, as the main
    path builds it (f32 on the card), and its condition number κ (f64)."""
    x = torch.as_tensor(gen.uniform(size=(n, 8)), dtype=torch.float64)
    t = math.sqrt(3.0) * torch.cdist(x, x) / ell
    K = (1.0 + t) * torch.exp(-t) + 0.1 * torch.eye(n, dtype=torch.float64)
    ev = torch.linalg.eigvalsh(K)
    return K.to(device=device, dtype=torch.float32), float(ev[-1] / ev[0])


def _launched(name, fn):
    before = cuda_ops.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("family", sorted(fused_gram.FAMILIES))
def test_gram_tile_matches_plain(cuda, gen, family):
    x = torch.as_tensor(gen.uniform(size=(300, 8)), dtype=torch.float32, device=cuda)
    z = torch.as_tensor(gen.uniform(size=(190, 8)), dtype=torch.float32, device=cuda)
    params = (torch.tensor(1.3, device=cuda),) if family in (4, 5) else ()
    pbuf = fused_gram._params_buffer(params, cuda)
    for symmetric, zz in ((False, z), (True, x)):
        got = _launched("gram_tile",
                        lambda: fused_gram.gram_tile(x, zz, family, params, symmetric))
        want = fused_gram.gram_tile_plain(x, zz, family, pbuf, symmetric)
        assert got.shape == want.shape and got.is_cuda
        # d² from the differences rounds ≲ (D + 1)·eps·d² ≤ 4.3e-6 in the unit
        # cube at D = 8, |dg/d(d²)| ≤ 2 → 3e-5
        assert float((got - want).abs().max()) <= 3e-5
        if symmetric:
            assert torch.equal(torch.diagonal(got), torch.diagonal(want))


@pytest.mark.parametrize("d", [1, 3, 8, 32, 40, 70])
@pytest.mark.parametrize("family", sorted(fused_gram.FAMILIES))
def test_gram_tile_widths_edges_and_alignment(cuda, gen, family, d):
    # D: each register width of the kernel (8, 16, 32 features) with features
    # past D zero, and the wide path past 32; m = 1, 63, 4097 leave rows that
    # are not 16-byte aligned (scalar stores); a row operand that starts 4
    # bytes into its buffer takes the 4-byte copies; symmetric on and off.
    # Tolerance, entry by entry: d² sums D squared differences, fused in the
    # kernel and not in the plain version, ≲ (D + 1)·eps·d² ≤
    # (2D + 4)·eps·(‖x‖² + ‖z‖²) (d² ≤ 2‖x‖² + 2‖z‖²), the allowance, times
    # |∂g/∂d²|, plus the 3e-5 of the other gram_tile tests for the map's
    # own rounding (expf, powf, cosf against torch's)
    n = 200
    x = torch.as_tensor(gen.uniform(size=(n, d)), dtype=torch.float32, device=cuda)
    params = (torch.tensor(1.3, device=cuda),) if family in (4, 5) else ()
    pbuf = fused_gram._params_buffer(params, cuda)
    x_odd = torch.empty(n * d + 1, device=cuda)[1:].view(n, d)
    x_odd.copy_(x)

    def check(xx, zz, symmetric):
        got = _launched("gram_tile",
                        lambda: fused_gram.gram_tile(xx, zz, family, params, symmetric))
        d2 = fused_gram._sqdist_plain(xx, zz, symmetric)
        want, dg, _ = fused_gram._map_vjp(family, d2, pbuf)
        norms = (xx * xx).sum(1)[:, None] + (zz * zz).sum(1)[None, :]
        tol = 3e-5 + dg.abs() * (2 * d + 4) * EPS32 * norms
        assert got.shape == want.shape and torch.all((got - want).abs() <= tol)
        return got

    for m in (1, 63, 4097):
        z = torch.as_tensor(gen.uniform(size=(m, d)), dtype=torch.float32, device=cuda)
        got = check(x, z, False)
        torch.testing.assert_close(check(x_odd, z, False), got, rtol=0, atol=0)
    K = check(x, x, True)
    assert torch.equal(K, K.T) and torch.all(torch.diagonal(K) == fused_gram._apply_map(
        family, torch.zeros(1, device=cuda), pbuf))


@pytest.mark.parametrize("B", [128, 48])
def test_chol_inv_block_matches_plain(cuda, gen, B):
    A = _spd(gen, B, cuda)
    dirty = torch.tril(A) + torch.triu(torch.full_like(A, 1e3), 1)  # upper never read
    L, W = _launched("chol_inv_block", lambda: blocked_chol.chol_inv_block(dirty))
    Lp, Wp = blocked_chol.chol_inv_block_plain(A)
    _close(L, Lp)
    _close(W, Wp)
    assert torch.all(torch.triu(L, 1) == 0) and torch.all(torch.triu(W, 1) == 0)
    bad = A - 10.0 * torch.eye(B, device=cuda)
    assert torch.isnan(blocked_chol.chol_inv_block(bad)[0]).any()
    # a main-path block, where the kernel's summation order matters more:
    # K + 0.1·I of a Matérn-3/2 gram (κ ≈ 1e3 at B = 128), at 10·κ·eps
    K, kappa = _matern_gram(gen, B, 3.0, cuda)
    L, W = _launched("chol_inv_block", lambda: blocked_chol.chol_inv_block(K))
    Lp, Wp = blocked_chol.chol_inv_block_plain(K)
    _close(L, Lp, rel=10.0 * kappa * EPS32)
    _close(W, Wp, rel=10.0 * kappa * EPS32)


def test_chol_block_matches_plain(cuda, gen):
    for B in (128, 48):
        A = _spd(gen, B, cuda)
        dirty = torch.tril(A) + torch.triu(torch.full_like(A, 1e3), 1)  # upper never read
        L = _launched("chol_block", lambda: blocked_chol.chol_block(dirty))
        _close(L, blocked_chol.chol_block_plain(A))
        assert torch.all(torch.triu(L, 1) == 0)
        # the factor half of chol_inv_block: the same routine, the same bits
        torch.testing.assert_close(L, blocked_chol.chol_inv_block(dirty)[0], rtol=0, atol=0)
        bad = A - 10.0 * torch.eye(B, device=cuda)
        L_bad = _launched("chol_block", lambda: blocked_chol.chol_block(bad))
        assert torch.isnan(L_bad).any() and torch.all(torch.triu(L_bad, 1) == 0)


def test_slab_factor_matches_plain_and_f64(cuda, gen):
    W_, B = 1024, 128
    S = _spd(gen, W_, cuda)
    L, Winv = _launched("slab_factor", lambda: blocked_chol.slab_factor(S, B))
    Lp, Wp = blocked_chol.slab_factor_plain(S, B)
    _close(L, Lp)
    _close(Winv, Wp)
    L64 = torch.linalg.cholesky(S.double())
    _close(L.double(), L64)
    assert torch.all(torch.triu(L, 1) == 0)
    # a main-path slab: K + 0.1·I of a Matérn-3/2 gram, κ ≈ 7.5e3, at 10·κ·eps
    K, kappa = _matern_gram(gen, W_, 2.0, cuda)
    L, Winv = _launched("slab_factor", lambda: blocked_chol.slab_factor(K, B))
    Lp, Wp = blocked_chol.slab_factor_plain(K, B)
    tol = 10.0 * kappa * EPS32
    _close(L, Lp, rel=tol)
    _close(Winv, Wp, rel=tol)
    _close(L.double(), torch.linalg.cholesky(K.double()), rel=tol)


def test_tri_inv_block_batched_and_strided(cuda, gen):
    n, B = 1024, 128
    L_cm = torch.linalg.cholesky(_spd(gen, n, cuda))  # column-major on the card
    L = L_cm.contiguous()
    want = blocked_chol.tri_inv_block_plain(L, B)
    got = _launched("tri_inv_block", lambda: blocked_chol.tri_inv_block(L, B))
    _close(got, want)
    # one block read in place out of the big factor (row stride n)
    one = _launched("tri_inv_block",
                    lambda: blocked_chol.tri_inv_block(L[256:384, 256:384], B)[0])
    _close(one, want[2])
    # a column-major factor is taken too (copied to row-major by the wrapper)
    torch.testing.assert_close(blocked_chol.tri_inv_block(L_cm, B), got, rtol=0, atol=0)
    torch.testing.assert_close(blocked_chol.tri_inv_block(L_cm[256:384, 256:384], B)[0], one,
                               rtol=0, atol=0)


@pytest.mark.parametrize("nb", [1, 36, 64])
@pytest.mark.parametrize("B", [8, 64, 120, 128])
def test_tri_inv_block_shapes_strides_and_contract(cuda, gen, B, nb):
    # nb lower-triangular diagonal blocks in an (nB, nB) matrix that holds
    # NaN everywhere else, above each block's diagonal too: a read outside
    # the blocks' lower triangles poisons the result
    n = nb * B
    blocks = np.tril(gen.normal(size=(nb, B, B)) * (0.5 / math.sqrt(B)), -1)
    blocks += np.eye(B) * gen.uniform(1.0, 2.0, size=(nb, 1, B))
    kappa = max(np.linalg.cond(b) for b in blocks)
    garbage = torch.triu(torch.full((B, B), math.nan), 1)
    L = torch.full((n, n + 16), math.nan, device=cuda)  # row stride n + 16
    for i in range(nb):
        L[i * B:(i + 1) * B, i * B:(i + 1) * B] = (torch.as_tensor(blocks[i], dtype=torch.float32)
                                                   + garbage).to(cuda)
    L = L[:, :n]
    got = _launched("tri_inv_block", lambda: blocked_chol.tri_inv_block(L, B))
    want = blocked_chol.tri_inv_block_plain(L, B)
    assert got.shape == (nb, B, B) and torch.isfinite(got).all()
    assert torch.all(torch.triu(got, 1) == 0)
    # both are forward substitutions in f32 with sums in another order
    _close(got, want, rel=10.0 * kappa * EPS32)
    f64 = torch.linalg.inv(torch.as_tensor(blocks)).to(cuda)
    _close(got.double(), f64, rel=10.0 * kappa * EPS32)
    # a column-major copy is taken too (copied to row-major by the wrapper)
    L_cm = L.T.contiguous().T
    torch.testing.assert_close(blocked_chol.tri_inv_block(L_cm, B), got, rtol=0, atol=0)
    # one block read in place, alone
    i = nb // 2
    one = _launched("tri_inv_block", lambda: blocked_chol.tri_inv_block(
        L[i * B:(i + 1) * B, i * B:(i + 1) * B], B)[0])
    torch.testing.assert_close(one, got[i], rtol=0, atol=0)


def test_tri_inv_block_takes_edges_that_are_multiples_of_8(cuda):
    with pytest.raises(ValueError):
        blocked_chol.tri_inv_block(torch.eye(100, device=cuda), 50)
    with pytest.raises(ValueError):
        blocked_chol.tri_inv_block(torch.eye(60, device=cuda), 60)


def test_cuda_tensors_never_take_the_plain_version(cuda):
    A = torch.eye(128, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        blocked_chol.chol_inv_block(A)
    with pytest.raises(TypeError):
        fused_gram.gram_tile(A, A, 0)
    with pytest.raises(ValueError):
        blocked_chol.slab_factor(torch.eye(1000, device=cuda), 128)


def test_block_kernels_take_edges_that_are_multiples_of_8(cuda):
    # the block routine factors 8-column groups (the TPU kernel's assert)
    A = torch.eye(50, device=cuda)
    for fn in (blocked_chol.chol_block, blocked_chol.chol_inv_block):
        with pytest.raises(ValueError):
            fn(A)
    with pytest.raises(ValueError):
        blocked_chol.slab_factor(torch.eye(120, device=cuda), 60)


def test_slice_on_the_card_matches_f64(cuda, gen):
    # N = 2100: npad = 2176 → two 1024 slabs through slab_factor and a
    # 128-wide tail through chol_inv_block; nb = 17 → the row-panel trtri
    # (tri_inv_block one block at a time); M = 300 ≥ _WIDE_RHS
    n, m, noise = 2100, 300, 0.1
    x = torch.as_tensor(gen.uniform(size=(n, 8)), dtype=torch.float32, device=cuda)
    y = torch.as_tensor(gen.normal(size=n), dtype=torch.float32, device=cuda)
    xs = torch.as_tensor(gen.uniform(size=(m, 8)), dtype=torch.float32, device=cuda)
    k = (1.1 * agt.with_lengthscale(agt.Matern32Kernel(), 0.9)).to(device=cuda,
                                                                   dtype=torch.float32)
    cuda_ops.reset_launches()
    fx = agt.GP(k)(x, noise)
    lp = fx.logpdf(y).detach()
    mu, var = agt.posterior(fx, y).mean_and_var(xs)
    torch.cuda.synchronize()
    forward = ("gram_tile", "slab_factor", "chol_inv_block", "tri_inv_block")
    assert all(cuda_ops.LAUNCHES[k] > 0 for k in forward), cuda_ops.LAUNCHES

    k64 = k.to(torch.float64)
    with torch.no_grad():
        K = agt.kernelmatrix(k64, x.double()) + noise * torch.eye(n, dtype=torch.float64,
                                                                  device=cuda)
        L = torch.linalg.cholesky(K)
        z = torch.linalg.solve_triangular(L, y.double()[:, None], upper=False)
        lp64 = -0.5 * (n * math.log(2 * math.pi) + 2 * torch.log(torch.diagonal(L)).sum()
                       + (z * z).sum())
        Ks = agt.kernelmatrix(k64, x.double(), xs.double())
        mu64 = Ks.T @ torch.cholesky_solve(y.double()[:, None], L)[:, 0]
        V = torch.linalg.solve_triangular(L, Ks, upper=False)
        var64 = torch.clamp(agt.kernelmatrix_diag(k64, xs.double()) - (V * V).sum(0), min=0)
    # κ(K) ≤ (n·σ² + noise)/noise
    tol = 10.0 * (n * 1.1 + noise) / noise * EPS32
    assert abs(float(lp) - float(lp64)) <= tol * abs(float(lp64))
    _close(mu.detach().double(), mu64, rel=tol)
    _close(var.detach().double(), var64, rel=tol)
    assert float(var.detach().min()) >= 0.0


@pytest.mark.parametrize("q", [1, 255, 256, 4097])
def test_the_held_inverse_on_the_card_matches_f64(cuda, gen, q):
    # N = 2048: the doubling trtri (one batched tri_inv_block) forms W = L⁻¹
    # on the posterior's first query; the next query, thin or wide, is one
    # product with W and launches no kernel of the inverse. Limits as in the
    # slice test above
    n, noise = 2048, 0.1
    x = torch.as_tensor(gen.uniform(size=(n, 8)), dtype=torch.float32, device=cuda)
    y = torch.as_tensor(gen.normal(size=n), dtype=torch.float32, device=cuda)
    xs = torch.as_tensor(gen.uniform(size=(q, 8)), dtype=torch.float32, device=cuda)
    k = (1.1 * agt.with_lengthscale(agt.Matern32Kernel(), 0.9)).to(device=cuda,
                                                                   dtype=torch.float32)
    with torch.no_grad():
        post = agt.posterior(agt.GP(k)(x, noise), y)
        _launched("tri_inv_block", lambda: post.mean_and_var(xs[:1]))
        before = dict(cuda_ops.LAUNCHES), dict(profiling.LIBRARY_CALLS)
        mu, var = post.mean_and_var(xs)
        torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["tri_inv_block"] == before[0]["tri_inv_block"]
    assert profiling.LIBRARY_CALLS["wide_inverse"] == before[1]["wide_inverse"]
    assert profiling.LIBRARY_CALLS["whiten_cached"] == before[1]["whiten_cached"] + 1
    assert profiling.LIBRARY_CALLS["tri_solve"] == before[1]["tri_solve"]

    k64 = k.to(torch.float64)
    with torch.no_grad():
        K = agt.kernelmatrix(k64, x.double()) + noise * torch.eye(n, dtype=torch.float64,
                                                                  device=cuda)
        L = torch.linalg.cholesky(K)
        Ks = agt.kernelmatrix(k64, x.double(), xs.double())
        mu64 = Ks.T @ torch.cholesky_solve(y.double()[:, None], L)[:, 0]
        V = torch.linalg.solve_triangular(L, Ks, upper=False)
        var64 = torch.clamp(agt.kernelmatrix_diag(k64, xs.double()) - (V * V).sum(0), min=0)
    tol = 10.0 * (n * 1.1 + noise) / noise * EPS32
    _close(mu.double(), mu64, rel=tol)
    _close(var.double(), var64, rel=tol)
    assert float(var.min()) >= 0.0


# ---------------------------------------------------------------------------
# The backward kernels: gram_bwd (the gram VJP) and logpdf_contraction
# ---------------------------------------------------------------------------


def _params(family, device):
    return (torch.tensor(1.3, device=device),) if family in (4, 5) else ()


@pytest.mark.parametrize("family", sorted(fused_gram.FAMILIES))
@pytest.mark.parametrize("mode", ["plain", "transpose", "sym"])
def test_gram_bwd_matches_plain(cuda, gen, family, mode):
    n, m = 300, (300 if mode == "sym" else 190)
    x = torch.as_tensor(gen.uniform(size=(n, 8)), dtype=torch.float32, device=cuda)
    z = x if mode == "sym" else torch.as_tensor(gen.uniform(size=(m, 8)),
                                                dtype=torch.float32, device=cuda)
    shape = (m, n) if mode == "transpose" else (n, m)
    C = torch.as_tensor(gen.normal(size=shape), dtype=torch.float32, device=cuda)
    params = _params(family, cuda)
    pbuf = fused_gram._params_buffer(params, cuda)
    sym = mode == "sym"
    got = _launched("gram_bwd", lambda: fused_gram.gram_bwd(x, z, C, family, params, sym, mode))
    want = fused_gram.gram_bwd_plain(x, z, C, family, pbuf, sym, mode)
    # x̄ sums ~m f32 terms Σ w(x − z) in another order: ≲ m·eps of the
    # terms, under 1e-4 of the largest
    # row; the hyperparameter bar is an f64 sum of f32 products that differ
    # by a few ulp (the card's expf/powf against torch's)
    scale = float(want[0].abs().max()) + 1e-6
    assert float((got[0] - want[0]).abs().max()) <= 1e-4 * scale
    assert abs(float(got[1]) - float(want[1])) <= 1e-4 * (abs(float(want[1])) + 1e-6)
    again = fused_gram.gram_bwd(x, z, C, family, params, sym, mode)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


# (rows of the row operand x, rows of the column operand z) per mode: a
# ragged edge in both, and the ∇prediction's three shapes at full width
_BWD_SHAPES = {"ragged": {"sym": (1000, 1000), "plain": (1000, 700), "transpose": (700, 1000)},
               "full": {"sym": (8192, 8192), "plain": (8192, 4096), "transpose": (4096, 8192)}}


# D: the main path's 8, then each register width of the kernel (8, 16, 32
# features a row) with features past D zero-padded (1, 3, 12, 32), and
# 32-feature chunks past 32 (40, 70)
@pytest.mark.parametrize("size,family,d", [("ragged", 2, 8), ("ragged", 4, 8), ("full", 2, 8),
                                           ("ragged", 2, 1), ("ragged", 4, 3),
                                           ("ragged", 2, 12), ("ragged", 4, 32),
                                           ("ragged", 2, 40), ("ragged", 4, 70)])
@pytest.mark.parametrize("mode", ["sym", "plain", "transpose"])
def test_gram_bwd_split_sweep(cuda, gen, mode, size, family, d):
    n, m = _BWD_SHAPES[size][mode]
    x = torch.as_tensor(gen.uniform(size=(n, d)), dtype=torch.float32, device=cuda)
    z = x if mode == "sym" else torch.as_tensor(gen.uniform(size=(m, d)),
                                                dtype=torch.float32, device=cuda)
    shape = (m, n) if mode == "transpose" else (n, m)
    C = torch.as_tensor(gen.normal(size=shape), dtype=torch.float32, device=cuda)
    params = _params(family, cuda)
    pbuf = fused_gram._params_buffer(params, cuda)
    sym = mode == "sym"
    got = _launched("gram_bwd", lambda: fused_gram.gram_bwd(x, z, C, family, params, sym, mode))
    want = fused_gram.gram_bwd_plain(x, z, C, family, pbuf, sym, mode)
    # as chip_smoke.py holds it: x̄ sums m f32 terms in another order and
    # form than the plain version, within 2·√m·eps of the sum of the terms'
    # magnitudes, entry by entry; the bar within 1e-4 relative
    Ct = C.T if mode == "transpose" else (C + C.T if sym else C)
    _, dg, _ = fused_gram._map_vjp(family, fused_gram._sqdist_plain(x, z, sym), pbuf)
    w = (Ct * dg).abs()
    with precision.full_f32():
        mag = 2.0 * (w.sum(1, keepdim=True) * x.abs() + w @ z.abs())
    del Ct, dg, w
    assert torch.all((got[0] - want[0]).abs() <= 2.0 * math.sqrt(m) * EPS32 * mag)
    assert abs(float(got[1]) - float(want[1])) <= 1e-4 * abs(float(want[1]))
    again = fused_gram.gram_bwd(x, z, C, family, params, sym, mode)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    # a cotangent whose rows are not 16-byte aligned takes 4-byte copies:
    # the same values, the same bits
    Cu = torch.empty((shape[0], shape[1] + 1), device=cuda)[:, 1:]
    Cu.copy_(C)
    odd = fused_gram.gram_bwd(x, z, Cu, family, params, sym, mode)
    assert torch.equal(odd[0], got[0]) and torch.equal(odd[1], got[1])


@pytest.mark.parametrize("same", [False, True])
def test_gram_with_40_features_runs_both_kernels(cuda, gen, same):
    # the gate takes any D: the gram goes through kernel 1 and its VJP
    # through kernel 6 (two 32-feature chunks), not the unfused formulation
    x = torch.as_tensor(gen.uniform(size=(600, 40)), dtype=torch.float32, device=cuda)
    z = x if same else torch.as_tensor(gen.uniform(size=(530, 40)), dtype=torch.float32,
                                       device=cuda)
    x.requires_grad_(True)
    z.requires_grad_(True)
    assert fused_gram.should_use_kernel(x, z)
    k = agt.Matern32Kernel()
    before = {name: cuda_ops.LAUNCHES[name] for name in ("gram_tile", "gram_bwd")}
    K = k.gram(x) if same else k.cross(x, z)
    C = torch.as_tensor(gen.normal(size=tuple(K.shape)), dtype=torch.float32, device=cuda)
    bars = torch.autograd.grad((K * C).sum(), (x,) if same else (x, z))
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["gram_tile"] == before["gram_tile"] + 1
    assert cuda_ops.LAUNCHES["gram_bwd"] == before["gram_bwd"] + (1 if same else 2)
    xd, zd, pbuf = x.detach(), z.detach(), fused_gram._params_buffer((), cuda)
    K0 = fused_gram.gram_tile_plain(xd, zd, 2, pbuf, same)
    assert float((K.detach() - K0).abs().max()) <= 3e-5
    if same:
        want = [fused_gram.gram_bwd_plain(xd, xd, C, 2, pbuf, True, "sym")[0]]
    else:
        want = [fused_gram.gram_bwd_plain(xd, zd, C, 2, pbuf, False, "plain")[0],
                fused_gram.gram_bwd_plain(zd, xd, C, 2, pbuf, False, "transpose")[0]]
    for got, w in zip(bars, want):  # as in test_gram_bwd_matches_plain
        assert float((got - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.parametrize("family", [2, 4])
def test_logpdf_contraction_matches_plain(cuda, gen, family):
    n, q = 333, 2  # a ragged edge, q > 1
    x = torch.as_tensor(gen.uniform(size=(n, 8)), dtype=torch.float32, device=cuda)
    L = torch.linalg.cholesky(_spd(gen, n, cuda))
    Linv = torch.linalg.inv(L)
    T = torch.tril(Linv.T @ Linv) + torch.triu(torch.full((n, n), 1e3, device=cuda), 1)
    a = torch.as_tensor(gen.normal(size=(n, q)), dtype=torch.float32, device=cuda)
    gbar = torch.tensor([0.7, -1.2], device=cuda)
    s2, gsum = torch.tensor(1.3, device=cuda), gbar.sum()
    params = _params(family, cuda)
    got = _launched("logpdf_contraction", lambda: fused_gram.logpdf_contraction(
        x, s2, a * gbar, a, gsum, T, family, params))
    want = fused_gram.logpdf_contraction_plain(x, s2, a * gbar, a, gsum, T, family,
                                               fused_gram._params_buffer(params, cuda))
    for g_, w_ in zip(got, want):  # as in test_gram_bwd_matches_plain
        scale = float(w_.abs().max()) + 1e-6
        assert float((g_ - w_).abs().max()) <= 1e-4 * scale
    again = fused_gram.logpdf_contraction(x, s2, a * gbar, a, gsum, T, family, params)
    assert all(torch.equal(g_, a_) for g_, a_ in zip(got, again))


# (n, D, q): n over a single tile, a ragged tile, and split grids (S = 16 at
# 1024, 7 at 4500); D over each register width and the wide path; q = 1 (the
# main path), 3 (staged as four columns) and 6 (read per entry)
_CONTRACTION_CASES = [(64, 1, 1), (100, 8, 3), (1024, 12, 6), (4500, 40, 1), (4500, 8, 3),
                      (1024, 1, 6)]


@pytest.mark.parametrize("n,d,q", _CONTRACTION_CASES)
@pytest.mark.parametrize("family", sorted(fused_gram.FAMILIES))
def test_logpdf_contraction_split_sweep(cuda, gen, family, n, d, q):
    x = torch.as_tensor(gen.uniform(size=(n, d)), dtype=torch.float32, device=cuda)
    # T: a lower triangle in a strided view (row stride n + 16) that holds NaN
    # above the diagonal and in the padding, as the backward's padded T may
    # hold anything there
    buf = torch.full((n, n + 16), math.nan, device=cuda)
    buf[:, :n] = torch.as_tensor(np.tril(gen.normal(size=(n, n)) / math.sqrt(n)),
                                 dtype=torch.float32, device=cuda)
    buf[:, :n] += torch.triu(torch.full((n, n), math.nan, device=cuda), 1)
    T = buf[:, :n]
    a = torch.as_tensor(gen.normal(size=(n, q)), dtype=torch.float32, device=cuda)
    gbar = torch.as_tensor(gen.normal(size=q), dtype=torch.float32, device=cuda)
    s2, gsum = torch.tensor(1.3, device=cuda), gbar.sum()
    params = _params(family, cuda)
    pbuf = fused_gram._params_buffer(params, cuda)
    args = (x, s2, a * gbar, a, gsum)
    got = _launched("logpdf_contraction",
                    lambda: fused_gram.logpdf_contraction(*args, T, family, params))
    want = fused_gram.logpdf_contraction_plain(*args, T, family, pbuf)
    assert all(torch.isfinite(t).all() for t in got)
    # as chip_smoke.py holds it: the scalars within 1e-4 relative; x̄ sums n
    # f32 terms in another order, within 2·√n·eps of the sum of the terms'
    # magnitudes, entry by entry
    for g_, w_ in zip(got[:2], want[:2]):
        assert abs(float(g_) - float(w_)) <= 1e-4 * abs(float(w_))
    Tl = torch.tril(T)
    with precision.full_f32():
        C = 0.5 * (a * gbar) @ a.T - 0.5 * gsum * (Tl + Tl.T - torch.diag(torch.diagonal(Tl)))
    _, dg, _ = fused_gram._map_vjp(family, fused_gram._sqdist_plain(x, x, True), pbuf)
    w = (C * s2 * dg).abs()
    with precision.full_f32():
        mag = 4.0 * (w.sum(1, keepdim=True) * x.abs() + w @ x.abs())
    assert torch.all((got[2] - want[2]).abs() <= 2.0 * math.sqrt(n) * EPS32 * mag)
    again = fused_gram.logpdf_contraction(*args, T, family, params)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    # the same T without the NaN, contiguous: the same bits
    clean = fused_gram.logpdf_contraction(*args, torch.tril(T).contiguous(), family, params)
    assert all(torch.equal(u, v) for u, v in zip(got, clean))


def test_grad_on_the_card_matches_f64(cuda, gen):
    # ∇ logpdf and ∇ of the prediction at N = 2100 through kernels 1-6,
    # against autograd of a dense f64 formulation on the same card
    n, m = 2100, 300
    x = torch.as_tensor(gen.uniform(size=(n, 8)), dtype=torch.float32, device=cuda)
    y = torch.as_tensor(gen.normal(size=n), dtype=torch.float32, device=cuda)
    xs = torch.as_tensor(gen.uniform(size=(m, 8)), dtype=torch.float32, device=cuda)

    def grads(dtype, which):
        th = [torch.tensor(v, dtype=dtype, device=cuda, requires_grad=True)
              for v in (1.1, 0.9, 0.1)]
        k = th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1])
        fx = agt.GP(k)(x.to(dtype), th[2])
        if which == "logpdf":
            out = fx.logpdf(y.to(dtype))
        else:
            mu, var = agt.posterior(fx, y.to(dtype)).mean_and_var(xs.to(dtype))
            out = mu.sum() + var.sum()
        return torch.stack(torch.autograd.grad(out, th)).double()

    for which, names in (("logpdf", ("logpdf_contraction", "tri_inv_block")),
                         ("pred", ("gram_bwd", "tri_inv_block"))):
        cuda_ops.reset_launches()
        got = grads(torch.float32, which)
        torch.cuda.synchronize()
        assert all(cuda_ops.LAUNCHES[k] > 0 for k in names), cuda_ops.LAUNCHES
        want = grads(torch.float64, which)
        # κ(K) ≤ (n·σ² + noise)/noise; first-order f32 rounding of the
        # factor, inverse and contractions: 10·κ·eps of the largest entry
        tol = 10.0 * (n * 1.1 + 0.1) / 0.1 * EPS32
        assert torch.isfinite(got).all()
        _close(got, want, rel=tol)


def test_set_enabled_false_launches_no_kernel(cuda, gen):
    # with both modules' kernels switched off, a card tensor at size takes
    # the library path: no port kernel launches, and the logpdf and its
    # gradient agree with the kernel path's within 10·κ·eps
    n = 2048
    x = torch.as_tensor(gen.uniform(size=(n, 8)), dtype=torch.float32, device=cuda)
    y = torch.as_tensor(gen.normal(size=n), dtype=torch.float32, device=cuda)

    def lml_and_grad():
        th = [torch.tensor(v, dtype=torch.float32, device=cuda, requires_grad=True)
              for v in (1.1, 0.9, 0.1)]
        lp = agt.GP(th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1]))(x, th[2]).logpdf(y)
        return torch.cat([lp.detach()[None], *[g[None] for g in torch.autograd.grad(lp, th)]])

    cuda_ops.reset_launches()
    on = lml_and_grad()
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["slab_factor"] > 0 and cuda_ops.LAUNCHES["logpdf_contraction"] > 0
    blocked_chol.set_enabled(False)
    fused_gram.set_enabled(False)
    try:
        cuda_ops.reset_launches()
        off = lml_and_grad()
        torch.cuda.synchronize()
        assert all(v == 0 for v in cuda_ops.LAUNCHES.values()), cuda_ops.LAUNCHES
    finally:
        blocked_chol.set_enabled(True)
        fused_gram.set_enabled(True)
    tol = 10.0 * (n * 1.1 + 0.1) / 0.1 * EPS32
    assert torch.isfinite(off).all()
    assert float(((on - off).abs() / off.abs()).max()) <= tol


def test_svgp_step_on_the_card_runs_gram_tile_and_all_gram_bwd_modes(cuda, gen, monkeypatch):
    # one joint SVGP step at the widths of the 50k configuration (M = 512,
    # B = 2048, D = 8): σ²·SE∘ARD, with σ², the ARD lengthscales, the noise,
    # z, m and C_raw all requiring grad. The forward launches the cross and
    # the symmetric gram_tile; the backward gram_bwd in the sym (Kzz), plain
    # (z of the cross gram) and transposed (the ARD-scaled batch) modes. The
    # gradient against the same step in f64 on the card (library path):
    # κ(Kzz + jitter) is ~20 here, so f32 rounding of the factor and of the
    # 2048-term sums stays well inside 1e-3 of each leaf's largest entry
    m, b, d = 512, 2048, 8
    x = torch.as_tensor(gen.uniform(size=(b, d)) * 4.0, dtype=torch.float32, device=cuda)
    y = torch.as_tensor(gen.normal(size=b), dtype=torch.float32, device=cuda)
    z0 = gen.uniform(size=(m, d)) * 4.0
    m0 = 0.3 * gen.normal(size=m)
    c0 = np.tril(0.02 * gen.normal(size=(m, m)), -1) + 0.5 * np.eye(m)
    modes = []
    orig = fused_gram.gram_bwd

    def spy(*a):
        modes.append(a[6])
        return orig(*a)

    monkeypatch.setattr(fused_gram, "gram_bwd", spy)

    def grads(dtype):
        leaves = [torch.tensor(v, dtype=dtype, device=cuda, requires_grad=True)
                  for v in (1.0, np.ones(d), 0.1, z0, m0, c0)]
        s2, ard, noise, z, mv, c_raw = leaves
        kern = agt.compose(agt.SqExponentialKernel(), agt.ARDTransform(1.0 / ard)) * s2
        sv = agt.SVGP(None, kern, z, mv, c_raw, torch.tensor(1e-6, dtype=dtype, device=cuda))
        loss = -agt.svgp_elbo(sv, x.to(dtype), y.to(dtype), noise, n_total=50_000)
        return [g.double() for g in torch.autograd.grad(loss, leaves)]

    cuda_ops.reset_launches()
    got = grads(torch.float32)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["gram_tile"] == 2 and cuda_ops.LAUNCHES["gram_bwd"] == 3
    assert sorted(modes) == ["plain", "sym", "transpose"]
    want = grads(torch.float64)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w, rel=1e-3)


def test_online_extend_past_capacity_returns_nan_on_the_card(cuda, gen):
    # a cache of capacity 2048 filled by 4 extends of 512 (gram_tile and the
    # wide solve's tri_inv_block on the card), held against batch
    # conditioning within 10·κ·eps, κ ≤ (n + 0.1)/0.1; then one extend past
    # the capacity: the write stays inside the buffers (no device assert)
    # and every later mean and variance is NaN
    from abstractgps_tpu_torch.models import online

    cap, b, d = 2048, 512, 8
    x = torch.as_tensor(gen.uniform(size=(cap + b, d)), dtype=torch.float32, device=cuda)
    y = torch.as_tensor(gen.normal(size=cap + b), dtype=torch.float32, device=cuda)
    xt = torch.as_tensor(gen.uniform(size=(1024, d)), dtype=torch.float32, device=cuda)
    f = agt.GP(agt.SEKernel())
    st = online.online_init(f, cap, d, dtype=torch.float32, device=cuda)
    cuda_ops.reset_launches()
    for i in range(0, cap, b):
        st = online.online_extend(st, x[i:i + b], y[i:i + b], 0.1)
    mu, var = online.online_mean_and_var(st, xt)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["gram_tile"] > 0 and cuda_ops.LAUNCHES["tri_inv_block"] > 0
    mu_b, var_b = agt.posterior(f(x[:cap], 0.1), y[:cap]).mean_and_var(xt)
    tol = 10.0 * (cap + 0.1) / 0.1 * EPS32
    assert torch.isfinite(mu).all() and torch.isfinite(var).all()
    _close(mu, mu_b, rel=tol)
    _close(var, var_b, rel=tol)
    st = online.online_extend(st, x[cap:], y[cap:], 0.1)
    mu1, var1 = online.online_mean_and_var(st, xt)
    torch.cuda.synchronize()
    assert int(st.count) == cap + b
    assert torch.isnan(mu1).all() and torch.isnan(var1).all()


def test_cg_matvec_launches_one_gram_tile_per_panel(cuda, gen):
    # a kernel the fused route does not take (a sum: Matérn-3/2 with ℓ plus
    # a constant) keeps the panel loop past max_dense_n: the gram rebuilt in
    # 1024-row panels, one gram_tile launch each (the last one ragged,
    # zero-padded), no fused matvec; it agrees with the dense f64 product to
    # f32 rounding of N-term sums
    from abstractgps_tpu_torch.ops.matvec import gram_matvec, make_gram_matvec

    n, d = 4196, 8
    x = torch.as_tensor(gen.uniform(size=(n, d)), dtype=torch.float32, device=cuda)
    V = torch.as_tensor(gen.normal(size=(n, 5)), dtype=torch.float32, device=cuda)
    nd = torch.full((n,), 0.1, dtype=torch.float32, device=cuda)
    k = (agt.with_lengthscale(agt.Matern32Kernel(), 0.9) + agt.ConstantKernel(0.3)).to(
        device=cuda, dtype=torch.float32)
    mv = make_gram_matvec(k, x, nd, panel=1024, max_dense_n=1024)
    cuda_ops.reset_launches()
    fused = profiling.LIBRARY_CALLS["cg_fused_matvec"]
    got = mv(V)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["gram_tile"] == 5, cuda_ops.LAUNCHES
    assert cuda_ops.LAUNCHES["gram_matvec"] == 0
    assert profiling.LIBRARY_CALLS["cg_fused_matvec"] == fused
    got_vec = gram_matvec(k, x, nd, V[:, 0], panel=1024)
    K64 = agt.kernelmatrix(copy.deepcopy(k).double(), x.double())
    want = K64 @ V.double() + 0.1 * V.double()
    _close(got.double(), want, rel=1e-4)
    _close(got_vec.double(), want[:, 0], rel=1e-4)


def _matvec_problem(gen, n, q, cuda):
    x = torch.as_tensor(gen.uniform(size=(n, 8)), dtype=torch.float32, device=cuda)
    V = torch.as_tensor(gen.normal(size=(n, q)), dtype=torch.float32, device=cuda)
    nd = torch.as_tensor(0.1 + 0.05 * gen.uniform(size=n), dtype=torch.float32, device=cuda)
    return x, V, nd


@pytest.mark.parametrize("n,q", [(32768, 33), (3000, 1), (3000, 33), (32767, 1), (32767, 33),
                                 (3000, 70)])
def test_gram_matvec_matches_plain_and_f64_bit_for_bit_on_repeat(cuda, gen, n, q):
    # the fused matvec σ²·K₀V + noise ⊙ V (Matérn-3/2, D = 8) against its
    # plain version and a dense f64 product: both within f32 rounding of
    # n-term sums, 4·√n·eps32·(σ²·Σ_j |V_jc| + noise·|V_ic|) (|K₀| ≤ 1); a
    # second call gives the same bits; one sweep and its in-order sum a
    # chunk of 33 columns, counted as one launch of the wrapper
    from torch.profiler import ProfilerActivity, profile

    from abstractgps_tpu_torch.ops import matvec

    x, V, nd = _matvec_problem(gen, n, q, cuda)
    buf = fused_gram._params_buffer((), cuda)
    s2 = torch.tensor(1.7, device=cuda)
    cuda_ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = matvec.gram_matvec_fused(x, V, 2, buf, s2, nd)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    chunks = -(-q // 33)
    assert cuda_ops.LAUNCHES["gram_matvec"] == 1
    assert sum("gram_matvec_sweep" in s for s in names) == chunks, names
    assert sum("gram_matvec_reduce" in s for s in names) == chunks, names
    again = matvec.gram_matvec_fused(x, V, 2, buf, s2, nd)
    assert torch.equal(got, again)
    plain = matvec.gram_matvec_plain(x, V, 2, buf, s2, nd)
    x64, V64 = x.double(), V.double()
    want = torch.empty_like(V64)
    for r0 in range(0, n, 4096):
        t = math.sqrt(3.0) * torch.cdist(x64[r0:r0 + 4096], x64)
        want[r0:r0 + 4096] = 1.7 * (((1.0 + t) * torch.exp(-t)) @ V64)
    want += nd.double()[:, None] * V64
    Va = V64.abs()
    tol = 4.0 * math.sqrt(n) * EPS32 * (1.7 * Va.sum(0)[None, :] + nd.double()[:, None] * Va)
    assert bool(((got.double() - want).abs() <= tol).all())
    assert bool(((plain.double() - want).abs() <= tol).all())


@pytest.mark.parametrize("family", sorted(fused_gram.FAMILIES))
def test_gram_matvec_every_family_and_width_matches_plain(cuda, gen, family):
    # each family at D = 1, 12 (the 16-feature path) and 40 (features read
    # through L1), q = 9, against the plain version within f32 rounding
    from abstractgps_tpu_torch.ops import matvec

    params = _params(family, cuda)
    buf = fused_gram._params_buffer(params, cuda)
    s2 = torch.tensor(1.3, device=cuda)
    for d in (1, 12, 40):
        x = torch.as_tensor(gen.uniform(size=(2100, d)) / math.sqrt(d), dtype=torch.float32,
                            device=cuda)
        V = torch.as_tensor(gen.normal(size=(2100, 9)), dtype=torch.float32, device=cuda)
        nd = torch.full((2100,), 0.1, dtype=torch.float32, device=cuda)
        got = matvec.gram_matvec_fused(x, V, family, buf, s2, nd)
        want = matvec.gram_matvec_plain(x, V, family, buf, s2, nd)
        Va = V.abs().double()
        tol = 8.0 * math.sqrt(2100) * EPS32 * (1.3 * Va.sum(0)[None, :] + 0.1 * Va)
        assert bool(((got.double() - want.double()).abs() <= tol).all()), (family, d)


class _ReplayNormals:
    """Normals drawn once in f64, handed out again in any dtype: the f32 and
    f64 runs of one CG estimator share their probes."""

    def __init__(self, seed, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.drawn, self.i = [], None

    def normal(self, shape, dtype, device):
        if self.i is None:
            self.drawn.append(torch.randn(shape, generator=self.gen, dtype=torch.float64,
                                          device=device))
            return self.drawn[-1].to(dtype)
        self.i += 1
        return self.drawn[self.i - 1].to(dtype)

    def replay(self):
        self.i = 0


def test_cg_logpdf_gradient_on_the_card_runs_gram_bwd(cuda, gen, monkeypatch):
    # the preconditioned CG logpdf at N = 3000 past max_dense_n: every CG
    # step run is one fused matvec (gram_matvec), the backward builds each
    # 1024-row panel with one gram_tile and takes its VJP through gram_bwd,
    # plain (the panel's rows) and transposed (the columns). Value and
    # gradient against the same
    # estimator (the same probes) in f64 on the card, within 10·κ·eps with
    # κ ≤ (n·σ² + noise)/noise
    n, panels, iters = 3000, 3, 60
    x = torch.as_tensor(gen.uniform(size=(n, 8)), dtype=torch.float32, device=cuda)
    y = torch.as_tensor(gen.normal(size=n), dtype=torch.float32, device=cuda)
    modes = []
    orig = fused_gram.gram_bwd
    monkeypatch.setattr(fused_gram, "gram_bwd", lambda *a: modes.append(a[6]) or orig(*a))
    draws = _ReplayNormals(3, cuda)

    def value_and_grad(dtype):
        th = [torch.tensor(v, dtype=dtype, device=cuda, requires_grad=True)
              for v in (1.1, 0.9, 0.1)]
        fx = agt.GP(th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1]))(x.to(dtype), th[2])
        lp = agt.cg_logpdf(fx, y.to(dtype), draws, num_probes=8, max_iters=iters, panel=1024,
                           max_dense_n=1024, precond_rank=16)
        return torch.cat([lp.detach()[None], *[g[None] for g in torch.autograd.grad(lp, th)]])

    cuda_ops.reset_launches()
    before = dict(profiling.LIBRARY_CALLS)
    got = value_and_grad(torch.float32)
    torch.cuda.synchronize()
    ran = profiling.LIBRARY_CALLS["cg_matvec"] - before["cg_matvec"]  # steps run, ≤ iters
    assert 0 < ran <= iters
    assert profiling.LIBRARY_CALLS["cg_fused_matvec"] - before["cg_fused_matvec"] == ran
    assert cuda_ops.LAUNCHES["gram_matvec"] == ran, cuda_ops.LAUNCHES
    assert cuda_ops.LAUNCHES["gram_tile"] == panels, cuda_ops.LAUNCHES
    assert sorted(modes) == ["plain"] * panels + ["transpose"] * panels
    draws.replay()
    want = value_and_grad(torch.float64)
    assert torch.isfinite(got).all()
    tol = 10.0 * (n * 1.1 + 0.1) / 0.1 * EPS32
    assert float(((got.double() - want).abs() / want.abs()).max()) <= tol


def test_cg_solver_stops_on_the_card_with_the_fixed_trip_loops_bits(cuda, gen):
    # the event-polled exit of mbcg at N = 3000 past max_dense_n (the fused
    # matvec, one launch a step) with a rank-16 preconditioner: X and the
    # coefficient stacks bit for bit the fixed-trip loop's on the same card
    # (the fused matvec repeats its bits); at most a few steps run after
    # every column froze (those launched before the host saw the flag), the
    # rest of the 256 skipped. The loop itself, over a dense matvec, runs
    # under CUDA's sync debug mode set to raise: no blocking host read
    from cg_fixed_trip import assert_bitwise, fixed_trip_mbcg

    from abstractgps_tpu_torch.models import iterative

    n, iters = 3000, 256
    x = torch.as_tensor(gen.uniform(size=(n, 8)), dtype=torch.float32, device=cuda)
    y = torch.as_tensor(gen.normal(size=n), dtype=torch.float32, device=cuda)
    th = [torch.tensor(v, dtype=torch.float32, device=cuda) for v in (1.1, 0.9)]
    k = th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1])
    nd = torch.full((n,), 0.1, dtype=torch.float32, device=cuda)
    probes = torch.randn((n, 8), generator=torch.Generator(device=cuda).manual_seed(5),
                         dtype=torch.float32, device=cuda)
    B = torch.cat([y[:, None], probes], dim=1)
    mv = iterative.make_gram_matvec(k, x, nd, panel=1024, max_dense_n=1024)
    psolve, _ = iterative._make_precond(k, x, nd, 16)
    before = dict(profiling.LIBRARY_CALLS)
    with profiling.recording():
        got = iterative.mbcg(mv, B, max_iters=iters, precond=psolve)
    calls = {name: v - before[name] for name, v in profiling.LIBRARY_CALLS.items()}
    assert_bitwise(got, fixed_trip_mbcg(mv, B, max_iters=iters, precond=psolve))
    assert calls["cg_fused_matvec"] == calls["cg_matvec"] > 0, calls  # the fused route
    assert calls["cg_matvec"] + calls["cg_skipped_matvec"] == iters, calls
    assert calls["cg_skipped_matvec"] > 0 and calls["cg_converged_matvec"] <= 8, calls

    A = agt.kernelmatrix(k, x) + torch.diag(nd)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dense = iterative.mbcg(lambda V: A @ V, B, max_iters=iters, precond=psolve)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert_bitwise(dense, fixed_trip_mbcg(lambda V: A @ V, B, max_iters=iters, precond=psolve))
    assert not dense[1][2][-1].any()


def _markov_problem(gen, n, cuda):
    # sorted U(0, n/160) times (the density of the validation width, 8192
    # over 50), y ~ N(0, 1), σ²·Matérn-3/2 with ℓ = 0.5, noise 0.1, f32
    t = torch.as_tensor(np.sort(gen.uniform(0.0, n / 160.0, size=n)), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.normal(size=n), dtype=torch.float32, device=cuda)
    return t, y


def test_markov_calls_launch_no_port_kernel(cuda, gen):
    # the state-space backend runs torch ops only: the parallel logpdf at
    # n = 20 000 (5 chunks of the scan) and its ∇, the sequential logpdf,
    # the marginals, the joint posterior and FFBS launch no port kernel;
    # the logpdfs hold the f32 contract of 1e-3 against the f64 filter on
    # the same card, and the ∇ the f64 parallel ∇ within 1e-3 a component
    from abstractgps_tpu_torch.models import markov

    t, y = _markov_problem(gen, 20_000, cuda)
    ts, ys = t[:512], y[:512]
    xq = torch.linspace(0.0, 3.0, 16, device=cuda)

    def logpdf_and_grad(dtype):
        th = [torch.tensor(v, dtype=dtype, device=cuda, requires_grad=True)
              for v in (1.0, 0.5, 0.1)]
        fx = agt.GP(th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1]))(t.to(dtype), th[2])
        lp = markov.markov_logpdf(fx, y.to(dtype), parallel=True)
        return lp, torch.stack(torch.autograd.grad(lp, th))

    cuda_ops.reset_launches()
    lp, g = logpdf_and_grad(torch.float32)
    fx = agt.GP(agt.with_lengthscale(agt.Matern32Kernel(), 0.5))(ts, 0.1)
    lp_seq = markov.markov_logpdf(fx, ys)
    post = agt.markov_posterior(fx, ys)
    outs = [lp, g, lp_seq, *post.mean_and_var(xq), *post.mean_and_cov(xq),
            post.rand(0, xq, 4)]
    torch.cuda.synchronize()
    assert all(v == 0 for v in cuda_ops.LAUNCHES.values()), cuda_ops.LAUNCHES
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    lp64, g64 = logpdf_and_grad(torch.float64)
    assert abs(float(lp) - float(lp64)) <= 1e-3 * abs(float(lp64))
    assert float(((g.double() - g64).abs() / g64.abs()).max()) <= 1e-3
    fx64 = agt.GP(agt.with_lengthscale(agt.Matern32Kernel(), 0.5))(ts.double(), 0.1)
    want = markov.markov_logpdf(fx64, ys.double())
    assert abs(float(lp_seq) - float(want)) <= 1e-3 * abs(float(want))


def test_markov_cuda_tensors_in_give_cuda_tensors_out(cuda, gen):
    from abstractgps_tpu_torch.models import markov

    t, y = _markov_problem(gen, 300, cuda)
    xq = torch.linspace(0.0, 2.0, 8, device=cuda)
    fx = agt.GP(1.3 * agt.with_lengthscale(agt.Matern52Kernel(), 0.7))(t, 0.1)
    for parallel in (False, True):
        post = agt.markov_posterior(fx, y, parallel=parallel)
        outs = [markov.markov_logpdf(fx, y, parallel=parallel),
                markov.markov_logpdf(fx, torch.stack([y, -y], 1), parallel=parallel),
                *post.mean_and_var(xq), *post.mean_and_cov(xq), post.cov(xq, xq[:3]),
                post.rand(torch.Generator(device=cuda).manual_seed(0), xq, 2),
                markov.markov_rand(fx, y, xq, 0, parallel=parallel)]
        for o in outs:
            assert o.device.type == "cuda" and o.dtype == torch.float32, (o.device, o.dtype)


def test_spans_on_the_card_hold_the_backward_thread_and_the_launches(cuda, gen):
    # autograd runs the backward of card tensors on a thread of its own: its
    # spans still hang under fit.backward; a recorded step counts the
    # launches an unrecorded step makes; a wide query, one inverse of L
    import abstractgps_tpu_torch.params as P
    from abstractgps_tpu_torch.utils import profiling

    x = torch.as_tensor(gen.uniform(size=(2048, 8)), dtype=torch.float32, device=cuda)
    y = torch.sin(x).sum(1)

    def build(th, xx):
        k = th["s2"] * agt.with_lengthscale(agt.Matern32Kernel(), th["ell"])
        return agt.GP(k)(xx, th["noise"])

    theta = {k: P.positive(torch.tensor(v, device=cuda))
             for k, v in dict(s2=1.0, ell=1.0, noise=0.1).items()}
    loss = agt.nlml(build, x, y)
    before = dict(cuda_ops.LAUNCHES)
    agt.fit(loss, theta, num_steps=1)
    torch.cuda.synchronize()
    off = {k: v - before[k] for k, v in cuda_ops.LAUNCHES.items() if v != before[k]}
    with profiling.recording() as rec:
        agt.fit(loss, theta, num_steps=1)
        torch.cuda.synchronize()
    spans = rec.spans
    (step,) = [s for s in spans if s.name == "fit.step"]
    assert {k[len("launch."):]: v for k, v in step.counts.items()
            if k.startswith("launch.")} == off and off
    bwd = next(i for i, s in enumerate(spans) if s.name == "fit.backward")
    lb = next(s for s in spans if s.name == "ops.logpdf_backward")
    assert lb.parent == bwd and lb.unit == step.unit == 0
    post = agt.posterior(build({k: P.constrain(v) for k, v in theta.items()}, x), y)
    with profiling.recording() as rec, torch.no_grad():
        post.mean_and_var(x[:300])
        post.mean_and_var(x[:100])
    roots = [s for s in rec.spans if s.name == "posterior.mean_and_var"]
    assert [s.counts.get("library.wide_inverse", 0) for s in roots] == [1, 0]
