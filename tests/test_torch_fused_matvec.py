"""The CG matvec's fused route (``ops/matvec.py``: ``gram_matvec_fused``,
on the CPU its plain twin ``gram_matvec_plain``) against the panel loop it
replaces for isotropic kernels, against the JAX package's ``gram_matvec``
and a dense f64 product, and the dispatch between the two routes.

The fused route is taken past ``max_dense_n`` for an isotropic kernel under
any nesting of ``ScaledKernel`` and ``TransformedKernel``, in f32 on the
kernel path: here a CPU tensor under ``fused_gram.set_interpret(True)``.
Every other kernel, and f64, keeps the panel loop.

Tolerances: the routes run the same sums in f32 in another order (σ²
applied to the product, not to each panel), so each differs from the exact
product by the rounding of n-term sums, bounded here by 4·√n·eps32 times the
sum of the terms' magnitudes, σ²·Σ_j |V_jc| + noise·|V_ic| (|K₀| ≤ 1 for
every family).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import kernel_tree

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu.ops import matvec as jm
from abstractgps_tpu_torch.models import iterative as ti
from abstractgps_tpu_torch.ops import distance, fused_gram
from abstractgps_tpu_torch.ops import matvec as tm
from abstractgps_tpu_torch.utils import profiling

EPS32 = 2.0 ** -24
N, MAX_DENSE = 2500, 1000  # past max_dense_n; 1024-row panels, the last one ragged

# one JAX kernel of each family of fused_gram.FAMILIES, by family id
FAMILY_KERNELS = {
    0: lambda: agp.SqExponentialKernel(),
    1: lambda: agp.ExponentialKernel(),
    2: lambda: agp.Matern32Kernel(),
    3: lambda: agp.Matern52Kernel(),
    4: lambda: agp.RationalQuadraticKernel(alpha=0.7),
    5: lambda: agp.GammaExponentialKernel(gamma=1.3),
    6: lambda: agp.CosineKernel(),
}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))
    monkeypatch.setattr(fused_gram, "_INTERPRET", True)


def _data(n, d, q, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    V = rng.normal(size=(n, q)).astype(np.float32)
    noise = (0.1 + 0.05 * rng.uniform(size=n)).astype(np.float32)
    return x, V, noise


def _torch_kernel(kj):
    return agt.kernel_from_numpy(kernel_tree(kj), device="cpu")


def _tol(V, noise, s2):
    """4·√n·eps32 · (σ²·Σ_j |V_jc| + noise_i |V_ic|), entry by entry."""
    Va = np.abs(np.asarray(V, dtype=np.float64))
    scale = s2 * Va.sum(axis=0)[None, :] + np.asarray(noise, dtype=np.float64)[:, None] * Va
    return 4.0 * np.sqrt(V.shape[0]) * EPS32 * scale


def _counted(fn):
    before = profiling.LIBRARY_CALLS["cg_fused_matvec"]
    out = fn()
    return out, profiling.LIBRARY_CALLS["cg_fused_matvec"] - before


@pytest.mark.parametrize("q", [1, 33, 70])
@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("family", sorted(fused_gram.FAMILIES))
def test_fused_route_matches_the_panel_loop_and_jax(family, d, q):
    # 2500 ragged rows, each family at D = 1 and 8, q = 1, 33 (one sweep on
    # the card) and 70 (three column chunks there)
    x, V, noise = _data(N, d, q, seed=family)
    kj = 1.3 * agp.with_lengthscale(FAMILY_KERNELS[family](), 0.8)
    kt = _torch_kernel(kj)
    xt, Vt, nt = map(torch.as_tensor, (x, V, noise))
    mv = tm.make_gram_matvec(kt, xt, nt, max_dense_n=MAX_DENSE)
    got, fused = _counted(lambda: mv(Vt))
    assert fused == 1 and got.dtype == torch.float32 and got.shape == (N, q)
    loop = tm.gram_matvec(kt, xt, nt, Vt).detach()  # the panel loop (here gram_tile_plain)
    want = np.asarray(jm.gram_matvec(kj, jnp.asarray(x, dtype=jnp.float64),
                                     jnp.asarray(noise, dtype=jnp.float64),
                                     jnp.asarray(V, dtype=jnp.float64)))
    tol = _tol(V, noise, 1.3)
    assert np.all(np.abs(got.numpy() - want) <= tol)
    assert np.all(np.abs(loop.numpy() - want) <= tol)
    vec = mv(Vt[:, 0])  # the vector form
    assert vec.shape == (N,) and np.all(np.abs(vec.numpy() - want[:, 0]) <= tol[:, 0])


_ARD = [0.7, 1.4, 1.1]


@pytest.mark.parametrize("nesting", ["scaled_scale", "scale_scaled", "scaled_ard", "ard_scaled",
                                     "doubly_scaled"])
def test_fused_route_peels_scalings_and_transforms(nesting):
    # σ² is the product of every ScaledKernel's variance, x̂ the inputs after
    # every transform, whichever way they nest around the isotropic kernel
    base = agt.Matern52Kernel()
    kt = {
        "scaled_scale": lambda: 1.7 * agt.with_lengthscale(base, 0.9),
        "scale_scaled": lambda: agt.with_lengthscale(1.7 * base, 0.9),
        "scaled_ard": lambda: 1.7 * agt.TransformedKernel(base, agt.ARDTransform(_ARD)),
        "ard_scaled": lambda: agt.TransformedKernel(1.7 * base, agt.ARDTransform(_ARD)),
        "doubly_scaled": lambda: 0.5 * (3.4 * agt.with_lengthscale(base, 0.9)),
    }[nesting]()
    x, V, noise = _data(N, 3, 5, seed=3)
    xt, Vt, nt = map(torch.as_tensor, (x, V, noise))
    mv = tm.make_gram_matvec(kt, xt, nt, max_dense_n=MAX_DENSE)
    got, fused = _counted(lambda: mv(Vt))
    assert fused == 1
    K64 = agt.kernelmatrix(kt.double(), xt.double()).detach()
    want = (K64 @ Vt.double() + nt.double()[:, None] * Vt.double()).numpy()
    assert np.all(np.abs(got.numpy() - want) <= _tol(V, noise, 1.7))


@pytest.mark.parametrize("case", ["sum", "product", "periodic", "linear", "f64", "dense"])
def test_other_kernels_f64_and_the_dense_branch_keep_their_route(case):
    # no fused matvec: the panel loop's own output, bit for bit, or the
    # dense branch at N ≤ max_dense_n
    x, V, noise = _data(N, 3, 4, seed=5)
    xt, Vt, nt = map(torch.as_tensor, (x, V, noise))
    m32 = agt.with_lengthscale(agt.Matern32Kernel(), 0.9)
    kt = {"sum": lambda: m32 + 0.5 * agt.SEKernel(),
          "product": lambda: m32 * agt.SEKernel(),
          "periodic": lambda: 1.3 * agt.PeriodicKernel(0.8),
          "linear": lambda: agt.LinearKernel(),
          "f64": lambda: 1.3 * m32, "dense": lambda: 1.3 * m32}[case]()
    if case == "f64":
        xt, Vt, nt = xt.double(), Vt.double(), nt.double()
    max_dense = N if case == "dense" else MAX_DENSE
    mv = tm.make_gram_matvec(kt, xt, nt, max_dense_n=max_dense)
    got, fused = _counted(lambda: mv(Vt))
    assert fused == 0
    if case != "dense":
        assert torch.equal(got, tm.gram_matvec(kt, xt, nt, Vt))


def _cg_value_and_grad(x, y):
    th = [torch.tensor(v, requires_grad=True) for v in (1.2, 0.8, 0.1)]
    k = th[0] * agt.with_lengthscale(agt.Matern32Kernel(), th[1])
    lp = ti.cg_logpdf(agt.GP(k)(x, th[2]), y, 4, num_probes=8, max_iters=100,
                      panel=512, max_dense_n=512, precond_rank=16)
    return torch.cat([lp.detach()[None], *[g[None] for g in torch.autograd.grad(lp, th)]])


def test_cg_logpdf_and_gradient_agree_between_the_routes(monkeypatch):
    # N = 2048 past max_dense_n = 512: the CG logpdf and its ∇ in (σ², ℓ,
    # noise) through the fused matvec and through the panel loop (the fused
    # route taken away), the same probes; every solver step of the first is
    # one fused matvec. The two f32 runs of the solver drift apart by
    # rounding: value within 1e-5, each ∇ leaf within 1e-3 relative
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(size=(2048, 4)).astype(np.float32))
    y = torch.as_tensor(rng.normal(size=2048).astype(np.float32))
    before = dict(profiling.LIBRARY_CALLS)
    got = _cg_value_and_grad(x, y)
    ran = {k: profiling.LIBRARY_CALLS[k] - before[k] for k in ("cg_matvec", "cg_fused_matvec")}
    assert ran["cg_matvec"] > 0 and ran["cg_fused_matvec"] == ran["cg_matvec"], ran
    monkeypatch.setattr(tm, "_fused_operator", lambda *a: None)
    before = profiling.LIBRARY_CALLS["cg_fused_matvec"]
    want = _cg_value_and_grad(x, y)
    assert profiling.LIBRARY_CALLS["cg_fused_matvec"] == before
    assert torch.isfinite(got).all()
    rel = ((got.double() - want.double()).abs() / want.double().abs())
    assert float(rel[0]) <= 1e-5 and float(rel[1:].max()) <= 1e-3, rel
