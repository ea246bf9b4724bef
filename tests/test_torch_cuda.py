"""The port's hand-written CUDA kernels against their plain torch versions,
on a card. Every test here is marked ``gpu`` and skips where no CUDA device
is present (decided in the ``cuda`` fixture, never at import).

This file imports neither JAX nor the JAX package and needs none of the
suite's conftest, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Tolerances: the kernel and its plain version run the same algorithm in f32
with sums in another order, so they differ by rounding, ~κ·eps of the
largest entry; the SPD inputs here have κ ≲ 40, and 1e-4 of the largest
entry bounds that with room. The slice test holds the f32 kernel path
against an f64 ``torch.linalg`` oracle on the same card at 10·κ·eps.
"""

import math

import numpy as np
import pytest
import torch

import abstractgps_tpu_torch as agt
from abstractgps_tpu_torch.ops import blocked_chol, cuda as cuda_ops, fused_gram

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
        # d² rounding ≲ 8·eps·(‖x‖² + ‖z‖²) at D = 8, |dg/d(d²)| ≤ 2 → 3e-5
        assert float((got - want).abs().max()) <= 3e-5
        if symmetric:
            assert torch.equal(torch.diagonal(got), torch.diagonal(want))


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


def test_tri_inv_block_batched_and_strided(cuda, gen):
    n, B = 1024, 128
    L_cm = torch.linalg.cholesky(_spd(gen, n, cuda))  # column-major on the card
    L = L_cm.contiguous()
    want = blocked_chol.tri_inv_block_plain(L, B)
    got = _launched("tri_inv_block", lambda: blocked_chol.tri_inv_block(L, B))
    _close(got, want)
    # one block read in place out of the big factor (row stride n)
    one = _launched("tri_inv_block",
                    lambda: blocked_chol._pallas_diag_inv(L[256:384, 256:384]))
    _close(one, want[2])
    # a column-major factor is taken too (copied to row-major by the wrapper)
    torch.testing.assert_close(blocked_chol.tri_inv_block(L_cm, B), got, rtol=0, atol=0)
    torch.testing.assert_close(blocked_chol._pallas_diag_inv(L_cm[256:384, 256:384]), one,
                               rtol=0, atol=0)


def test_cuda_tensors_never_take_the_plain_version(cuda):
    A = torch.eye(128, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        blocked_chol.chol_inv_block(A)
    with pytest.raises(TypeError):
        fused_gram.gram_tile(A, A, 0)
    with pytest.raises(ValueError):
        blocked_chol.slab_factor(torch.eye(1000, device=cuda), 128)


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
    assert all(v > 0 for v in cuda_ops.LAUNCHES.values()), cuda_ops.LAUNCHES

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
