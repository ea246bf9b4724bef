"""The port's plain modules against the JAX package at f64 on the CPU:
distance, noise, means, the kernel zoo and algebra, covmat, FiniteGP,
the weight conversion, the precision policy and the device policy; plus
the rule that the port imports neither JAX nor the JAX package.

Tolerance: both sides run f64 LAPACK-class algorithms on the same inputs,
so results agree to ~1e-10 relative (1e-12 where no factorization is
involved).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import kernel_tree, spd

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu.ops import covmat as covmat_j
from abstractgps_tpu_torch.ops import covmat, distance, precision

F64 = dict(rtol=1e-10, atol=1e-12)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _n(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

KERNELS = {
    "se": lambda: agp.SEKernel(),
    "exp": lambda: agp.ExponentialKernel(),
    "m32": lambda: agp.Matern32Kernel(),
    "m52": lambda: agp.Matern52Kernel(),
    "rq": lambda: agp.RationalQuadraticKernel(alpha=0.7),
    "gexp": lambda: agp.GammaExponentialKernel(gamma=1.4),
    "cos": lambda: agp.CosineKernel(),
    "periodic": lambda: agp.PeriodicKernel(period=[0.8, 1.3]),
    "white": lambda: agp.WhiteKernel(),
    "const": lambda: agp.ConstantKernel(c=0.6),
    "zero": lambda: agp.ZeroKernel(),
    "linear": lambda: agp.LinearKernel(c=0.3),
    "poly": lambda: agp.PolynomialKernel(degree=3, c=0.2),
    "expdot": lambda: agp.ExponentiatedKernel(),
    "scaled_ls": lambda: 1.7 * agp.with_lengthscale(agp.Matern52Kernel(), 0.6),
    "ard": lambda: agp.with_lengthscale(agp.SEKernel(), np.array([0.5, 2.0])),
    "linear_tf": lambda: agp.compose(agp.SEKernel(),
                                     agp.LinearTransform(np.array([[1.0, 0.5], [0.2, -0.3],
                                                                   [0.0, 1.1]]))),
    "sum_prod": lambda: (agp.SEKernel() + 0.5 * agp.Matern32Kernel())
    * agp.with_lengthscale(agp.RationalQuadraticKernel(alpha=2.0), 1.5),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_matches_jax(rng, name):
    x = rng.uniform(size=(12, 2))
    z = rng.uniform(size=(7, 2))
    x[3] = x[5]  # a duplicate row for WhiteKernel's equality semantics
    kj = KERNELS[name]()
    kt = agt.kernel_from_numpy(kernel_tree(kj))
    np.testing.assert_allclose(_n(agt.kernelmatrix(kt, _t(x), _t(z))),
                               np.asarray(agp.kernelmatrix(kj, x, z)), **F64)
    np.testing.assert_allclose(_n(agt.kernelmatrix(kt, _t(x))),
                               np.asarray(agp.kernelmatrix(kj, x)), **F64)
    np.testing.assert_allclose(_n(agt.kernelmatrix_diag(kt, _t(x))),
                               np.asarray(agp.kernelmatrix_diag(kj, x)), **F64)
    np.testing.assert_allclose(float(kt(_t(x[0]), _t(z[1])).detach()), float(kj(x[0], z[1])), **F64)


def test_kernel_hyperparameters_are_parameters():
    k = 1.5 * agt.with_lengthscale(agt.RationalQuadraticKernel(alpha=0.5), 2.0)
    names = {n for n, _ in k.named_parameters()}
    assert names == {"variance", "kernel.transform.s", "kernel.kernel.alpha"}
    x = torch.rand(6, 2, dtype=torch.float64)
    agt.kernelmatrix(k, x).sum().backward()
    assert all(p.grad is not None for p in k.parameters())


def test_matern_constructor_and_algebra():
    assert isinstance(agt.MaternKernel(0.5), agt.ExponentialKernel)
    assert isinstance(agt.MaternKernel(2.5), agt.Matern52Kernel)
    with pytest.raises(NotImplementedError):
        agt.MaternKernel(1.0)
    s = agt.SEKernel() + agt.Matern32Kernel() + agt.CosineKernel()
    assert isinstance(s, agt.KernelSum) and len(s.kernels) == 3
    p = agt.SEKernel() * agt.Matern32Kernel() * agt.CosineKernel()
    assert isinstance(p, agt.KernelProduct) and len(p.kernels) == 3
    with pytest.raises(TypeError):
        agt.ConstMean("a")


# ---------------------------------------------------------------------------
# distance, means, noise
# ---------------------------------------------------------------------------


def test_distance_and_inputs(rng):
    X = rng.normal(size=(3, 5))
    np.testing.assert_array_equal(_n(agt.col_vecs(X)), np.asarray(agp.col_vecs(X)))
    np.testing.assert_array_equal(_n(agt.as_inputs(X, obsdim=2)),
                                  np.asarray(agp.as_inputs(X, obsdim=2)))
    assert tuple(agt.as_inputs(np.arange(4.0)).shape) == (4, 1)
    assert tuple(agt.as_inputs(2.0).shape) == (1, 1)
    x = rng.normal(size=(9, 3))
    d2 = distance.pairwise_sqdist(_t(x))
    assert np.all(np.diagonal(_n(d2)) == 0.0) and _n(d2).min() >= 0.0
    from abstractgps_tpu.ops.distance import pairwise_sqdist

    np.testing.assert_allclose(_n(d2), np.asarray(pairwise_sqdist(x)), **F64)
    np.testing.assert_allclose(_n(distance.pairwise_sqdist(_t(x), _t(x[:4]))),
                               np.asarray(pairwise_sqdist(x, x[:4])), **F64)
    d2 = torch.tensor([0.0, 4.0], dtype=torch.float64, requires_grad=True)
    distance.safe_sqrt(d2).sum().backward()
    assert torch.isfinite(d2.grad).all()  # finite gradient at 0


def test_means_match_jax(rng):
    x = rng.normal(size=(6, 2))
    np.testing.assert_array_equal(_n(agt.ZeroMean()(_t(x))), np.zeros(6))
    np.testing.assert_allclose(_n(agt.as_mean(1.5)(_t(x))), np.full(6, 1.5))
    fn_t = agt.CustomMean(lambda v: torch.sum(v * v))
    fn_j = agp.CustomMean(lambda v: jnp.sum(v * v))
    np.testing.assert_allclose(_n(agt.mean_vector(fn_t, _t(x))), np.asarray(fn_j(x)), **F64)
    batched = agt.CustomMean(lambda p, v: p * v[:, 0], params=torch.tensor(2.0), batched=True)
    np.testing.assert_allclose(_n(batched(_t(x))), 2.0 * x[:, 0], **F64)
    assert isinstance(agt.as_mean(None), agt.ZeroMean)
    assert isinstance(agt.as_mean(lambda v: v), agt.CustomMean)


def test_noise_structures(rng):
    n = 4
    K = _t(spd(rng, n))
    iso = agt.as_noise(0.3, n, like=K)
    assert isinstance(iso, agt.IsotropicNoise) and iso.variance.dtype == torch.float64
    np.testing.assert_allclose(_n(iso.add_to(K)), _n(K) + 0.3 * np.eye(n), **F64)
    np.testing.assert_allclose(float(iso.logdet()), n * np.log(0.3), **F64)
    v = rng.uniform(0.1, 1.0, size=n)
    dg = agt.as_noise(_t(v), n)
    assert isinstance(dg, agt.DiagonalNoise)
    np.testing.assert_allclose(float(dg.tr_solve(_t(np.ones(n)))), np.sum(1 / v), **F64)
    C = spd(rng, n)
    dn = agt.as_noise(_t(C), n)
    assert isinstance(dn, agt.DenseNoise)
    np.testing.assert_allclose(float(dn.logdet()), np.linalg.slogdet(C)[1], **F64)
    with pytest.raises(NotImplementedError):
        dn.tr_solve(_t(np.ones(n)))
    assert isinstance(agt.noise_block_diag(iso, dg), agt.DiagonalNoise)
    bd = agt.noise_block_diag(dg, dn)
    assert isinstance(bd, agt.DenseNoise) and tuple(bd.cov.shape) == (2 * n, 2 * n)
    with pytest.raises(ValueError):
        agt.as_noise(_t(np.ones(3)), n)
    default = agt.as_noise(None, n)
    assert float(default.variance) == agt.DEFAULT_NOISE_VARIANCE == 1e-18


# ---------------------------------------------------------------------------
# covmat
# ---------------------------------------------------------------------------


def test_covmat_matches_jax(rng):
    n = 9
    A = spd(rng, n)
    L = np.linalg.cholesky(A)
    X = rng.normal(size=(n, 4))
    Y = rng.normal(size=(n, 4))
    x = rng.normal(size=n)
    Lt, Xt, Yt, xt = map(_t, (L, X, Y, x))
    np.testing.assert_allclose(_n(covmat.cholesky_lower(_t(A))), L, **F64)
    for name in ("solve_lower", "solve_upper", "chol_solve", "Xt_A_X", "Xt_invA_X",
                 "diag_Xt_A_X", "diag_Xt_invA_X", "tr_Xt_invA_X"):
        for arg, argj in ((Xt, X), (xt, x)):
            got = getattr(covmat, name)(Lt, arg)
            want = getattr(covmat_j, name)(L, argj)
            np.testing.assert_allclose(_n(got), np.asarray(want), err_msg=name, **F64)
    for name in ("Xt_A_Y", "Xt_invA_Y", "diag_Xt_A_Y", "diag_Xt_invA_Y"):
        np.testing.assert_allclose(_n(getattr(covmat, name)(Xt, Lt, Yt)),
                                   np.asarray(getattr(covmat_j, name)(X, L, Y)),
                                   err_msg=name, **F64)
    for name in ("At_A", "diag_At_A", "tr_At_A"):
        np.testing.assert_allclose(_n(getattr(covmat, name)(Xt)),
                                   np.asarray(getattr(covmat_j, name)(X)), **F64)
    np.testing.assert_allclose(_n(covmat.diag_At_B(Xt, Yt)),
                               np.asarray(covmat_j.diag_At_B(X, Y)), **F64)
    L2 = np.linalg.cholesky(spd(rng, n))
    np.testing.assert_allclose(_n(covmat.Xtinv_A_Xinv(Lt, _t(L2))),
                               np.asarray(covmat_j.Xtinv_A_Xinv(L, L2)), **F64)
    np.testing.assert_allclose(float(covmat.logdet_from_chol(Lt)),
                               np.linalg.slogdet(A)[1], **F64)
    np.testing.assert_allclose(_n(covmat.add_jitter(_t(A), 0.1)), A + 0.1 * np.eye(n), **F64)
    # non-PSD → NaN factor, never an exception
    assert torch.isnan(covmat.cholesky_lower(_t(A - 10 * np.eye(n)))).any()


def test_cholesky_updates_match_jax(rng):
    A = spd(rng, 12)
    L11 = np.linalg.cholesky(A[:8, :8])
    got = covmat.update_chol(_t(L11), _t(A[:8, 8:]), _t(A[8:, 8:]))
    np.testing.assert_allclose(_n(got), np.linalg.cholesky(A), **F64)
    L = np.linalg.cholesky(A)
    V = rng.normal(size=(12, 3))
    for block in (256, 5):
        got = covmat.lowrank_update_chol(_t(L), _t(V), block=block)
        want = covmat_j.lowrank_update_chol(L, V, block=block)
        np.testing.assert_allclose(_n(got), np.asarray(want), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(_n(covmat.lowrank_update_chol(_t(L), _t(V[:, 0]))),
                               np.linalg.cholesky(A + np.outer(V[:, 0], V[:, 0])),
                               rtol=1e-9, atol=1e-10)


def test_substitution_solves_scope(rng, monkeypatch):
    from abstractgps_tpu_torch.ops import blocked_chol

    monkeypatch.setattr(blocked_chol, "_INTERPRET", True)
    monkeypatch.setattr(blocked_chol, "_MIN_N", 8)
    monkeypatch.setattr(blocked_chol, "_WIDE_RHS", 2)
    L = torch.linalg.cholesky(torch.as_tensor(spd(rng, 16), dtype=torch.float32))
    B = torch.randn(16, 4)
    calls = []
    monkeypatch.setattr(blocked_chol, "solve_lower_wide",
                        lambda L_, B_: calls.append(1) or B_)
    covmat.solve_lower(L, B)
    assert calls == [1]
    with covmat.substitution_solves():
        X = covmat.solve_lower(L, B)
    assert calls == [1]
    torch.testing.assert_close(L @ X, B, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# FiniteGP and GP at f64 (the torch.linalg path)
# ---------------------------------------------------------------------------


def test_finite_gp_matches_jax(rng):
    n = 15
    x = rng.uniform(size=(n, 2))
    y = rng.normal(size=n)
    Y = rng.normal(size=(n, 3))
    noise = rng.uniform(0.05, 0.2, size=n)
    kj = 1.3 * agp.with_lengthscale(agp.Matern52Kernel(), 0.8)
    kt = agt.kernel_from_numpy(kernel_tree(kj))
    fj = agp.GP(0.4, kj)(x, noise)
    ft = agt.GP(0.4, kt)(_t(x), _t(noise))
    for name in ("logpdf", "sqmahal", "gradlogpdf", "loglikelihood"):
        for arg in (y, Y) if name != "gradlogpdf" else (y,):
            np.testing.assert_allclose(_n(getattr(ft, name)(_t(arg))),
                                       np.asarray(getattr(fj, name)(arg)), err_msg=name,
                                       rtol=1e-10, atol=1e-10)
    for name in ("invcov", "logdetcov", "mean", "var", "cov"):
        np.testing.assert_allclose(_n(getattr(ft, name)()), np.asarray(getattr(fj, name)()),
                                   err_msg=name, rtol=1e-10, atol=1e-10)
    for a, b in zip(ft.marginals(), fj.marginals()):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-10)
    assert len(ft) == n
    # rand = m + L ξ with ξ from the generator
    g1 = torch.Generator().manual_seed(3)
    s = agt.rand(g1, ft, 4)
    m, L = ft._chol()
    xi = torch.randn((n, 4), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    np.testing.assert_allclose(_n(s), _n(m[:, None] + L @ xi), rtol=1e-12)
    assert tuple(ft.rand(g1).shape) == (n,)
    # free functions of (f, x)
    f = agt.GP(kt)
    np.testing.assert_allclose(_n(agt.mean_and_cov(f, _t(x))[1]),
                               np.asarray(agp.mean_and_cov(agp.GP(kj), x)[1]), **F64)
    with pytest.raises(TypeError):
        agt.GP("not a kernel")


# ---------------------------------------------------------------------------
# conversion, precision, device policy, import rule
# ---------------------------------------------------------------------------


def test_convert_round_trip_and_refusals(rng):
    kj = 2.0 * agp.with_lengthscale(agp.PolynomialKernel(degree=2, c=0.5), np.array([0.5, 1.5]))
    tree = kernel_tree(kj)
    k32 = agt.kernel_from_numpy(tree, dtype=torch.float32)
    assert all(p.dtype == torch.float32 for p in k32.parameters())
    assert k32.kernel.kernel.degree == 2
    with pytest.raises(ValueError):
        agt.kernel_from_numpy({"type": "NoSuchKernel"})
    assert isinstance(agt.mean_from_numpy({"type": "ConstMean", "c": np.array(1.5)}),
                      agt.ConstMean)
    nz = agt.noise_from_numpy({"type": "DiagonalNoise", "variances": np.ones(3)})
    assert isinstance(nz, agt.DiagonalNoise)
    iso = agt.noise_from_numpy({"type": "IsotropicNoise", "variance": np.array(0.1), "n": 3})
    assert iso.n == 3


def test_convert_follows_the_default_device():
    # weights carried across land where as_tensor puts inputs: on the
    # package's default device, and never on the CPU when that is "cuda"
    kernel = {"type": "ScaledKernel", "variance": np.array(1.3),
              "kernel": {"type": "Matern32Kernel"}}
    mean = {"type": "ConstMean", "c": np.array(0.5)}
    noise = {"type": "DiagonalNoise", "variances": np.ones(3)}
    params = {"s2": {"type": "Positive", "raw": np.array(0.2)}, "c": np.array(1.0)}
    calls = (lambda: list(agt.kernel_from_numpy(kernel).parameters()),
             lambda: [agt.mean_from_numpy(mean).c],
             lambda: [agt.noise_from_numpy(noise).variances],
             lambda: [agt.params_from_numpy(params)["s2"].raw,
                      agt.params_from_numpy(params)["c"]])
    before = agt.get_default_device()
    try:
        for device in ("cpu", "meta"):
            agt.set_default_device(device)
            for call in calls:
                assert all(t.device.type == device for t in call())
        agt.set_default_device("cpu")
        assert agt.kernel_from_numpy(kernel, device="meta").variance.device.type == "meta"
        agt.set_default_device("cuda")
        for call in calls:
            if torch.cuda.is_available():
                assert all(t.is_cuda for t in call())
            else:
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    call()
    finally:
        agt.set_default_device(before)
    assert agt.get_default_device() == before


def test_precision_policy_scopes_tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    seen = []

    @precision.precise
    def probe():
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))

    try:
        probe()
        assert seen[-1] == (False, False)  # "high" → IEEE f32, not TF32
        precision.set_matmul_precision("default")
        probe()
        assert seen[-1] == (True, True)
        with precision.full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32  # restored
        with pytest.raises(ValueError):
            agt.set_matmul_precision("tf32")
    finally:
        precision.set_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = False
    assert agt.get_matmul_precision() == "high"


def test_device_policy(monkeypatch):
    t = torch.ones(3, dtype=torch.float32)
    assert agt.as_inputs(t).device.type == "cpu"  # tensors keep their device
    assert agt.as_inputs([1.0, 2.0]).device.type == "cpu"
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cuda"))
    if torch.cuda.is_available():
        assert agt.as_inputs([1.0]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            agt.as_inputs([1.0, 2.0])
    agt.set_default_device("cpu")
    assert agt.get_default_device() == torch.device("cpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "abstractgps_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "abstractgps_tpu"), (f, mod)
    assert jax.__name__ == "jax"  # the test side holds both
