"""Conformance suites for GP implementations (downstream self-certification).

Counterpart of the JAX package's ``utils/test_utils.py`` (reference:
src/util/TestUtils.jl:1-220), three nested suites matching the three API
tiers:

- ``test_finitegp_primary_public_interface`` (:24-71)
- ``test_finitegp_primary_and_secondary_interface`` (:87-106)
- ``test_internal_abstractgps_interface`` (:133-218), including the
  analytic invariant ``elbo(VFE(f(x, jitter)), fx, y) ≈ logpdf(fx, y)``
  when inducing points = data points (:213-217).

Plain-assert style (no pytest dependency) so any downstream GP type can
self-certify: pass a projection/process and a ``torch.Generator`` (where
the JAX package takes a key), and the suite raises on the first violated
contract.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "test_finitegp_primary_public_interface",
    "test_finitegp_primary_and_secondary_interface",
    "test_internal_abstractgps_interface",
]

# pytest must not collect the suite functions themselves
__test__ = False


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **kw)


def test_finitegp_primary_public_interface(generator, fx, atol=1e-6):
    """Primary Public API conformance (src/util/TestUtils.jl:24-71)."""
    __tracebackhide__ = True
    n = len(fx)

    m = fx.mean()
    v = fx.var()
    assert tuple(m.shape) == (n,), f"mean shape {tuple(m.shape)} != ({n},)"
    assert tuple(v.shape) == (n,), f"var shape {tuple(v.shape)} != ({n},)"
    assert bool(torch.all(v >= -atol)), "negative marginal variance"

    mm, vv = fx.mean_and_var()
    _close(mm, m, atol=atol)
    _close(vv, v, atol=atol)

    means, stds = fx.marginals()
    _close(means, m, atol=atol)
    _close(_np(stds) ** 2, v, atol=10 * atol)

    s1 = fx.rand(generator)
    assert tuple(s1.shape) == (n,), "single sample shape"
    s3 = fx.rand(generator, 3)
    assert tuple(s3.shape) == (n, 3), "batch sample shape"

    lp = fx.logpdf(s1)
    assert lp.shape == (), "logpdf of vector must be scalar"
    assert bool(torch.isfinite(lp)), "non-finite logpdf"
    lps = fx.logpdf(s3)
    assert tuple(lps.shape) == (3,), "column-wise logpdf shape"
    # column-wise logpdf ≡ per-column vector logpdf
    _close(lps[0], fx.logpdf(s3[:, 0]), rtol=1e-5, atol=atol)

    y = fx.rand(generator)
    post = fx.posterior(y)
    pm = post.mean(fx.x)
    assert tuple(pm.shape) == (n,), "posterior mean shape"


def test_finitegp_primary_and_secondary_interface(generator, fx, atol=1e-6):
    """Adds the Secondary API: explicit covariance consistency + PSD
    (src/util/TestUtils.jl:87-106)."""
    __tracebackhide__ = True
    test_finitegp_primary_public_interface(generator, fx, atol=atol)
    n = len(fx)
    C = fx.cov()
    assert tuple(C.shape) == (n, n), "cov shape"
    _close(C, C.T, atol=atol)
    _close(torch.diagonal(C), fx.var(), atol=10 * atol)
    m2, C2 = fx.mean_and_cov()
    _close(m2, fx.mean(), atol=atol)
    _close(C2, C, atol=atol)
    eigmin = float(np.linalg.eigvalsh(_np(C))[0])
    assert eigmin > -1e-6, f"cov not PSD: eigmin={eigmin}"


def test_internal_abstractgps_interface(generator, f, x, z, atol=1e-6):
    """Internal AbstractGPs API conformance (src/util/TestUtils.jl:133-218).

    ``f`` is any AbstractGP; ``x`` (N,D) and ``z`` (M,D) are distinct
    input sets.
    """
    __tracebackhide__ = True
    n, m_ = x.shape[0], z.shape[0]

    m = f.mean(x)
    v = f.var(x)
    C = f.cov(x)
    Cxz = f.cov(x, z)
    assert tuple(m.shape) == (n,)
    assert tuple(v.shape) == (n,)
    assert tuple(C.shape) == (n, n)
    assert tuple(Cxz.shape) == (n, m_)

    # symmetry + consistency (TestUtils :164, :172-183)
    _close(C, C.T, atol=atol)
    _close(torch.diagonal(C), v, atol=10 * atol)
    _close(Cxz, f.cov(z, x).T, atol=atol)
    _close(f.cov(x, x), C, atol=10 * atol)

    eigmin = float(np.linalg.eigvalsh(_np(C))[0])
    assert eigmin > -1e-6, f"cov not PSD: eigmin={eigmin}"

    # fused ops consistency (TestUtils :185-199)
    mc_m, mc_C = f.mean_and_cov(x)
    mv_m, mv_v = f.mean_and_var(x)
    _close(mc_m, m, atol=atol)
    _close(mc_C, C, atol=atol)
    _close(mv_m, m, atol=atol)
    _close(mv_v, v, atol=10 * atol)

    # projection round-trip (the FiniteGP suite on f(x))
    fx = f(x, 1e-3)
    test_finitegp_primary_and_secondary_interface(generator, fx, atol=1e-4)

    # the analytic sparse-collapse invariant (TestUtils :213-217):
    # elbo with inducing = data equals the exact lml to rtol 1e-5
    from ..models.sparse import VFE, elbo

    y = fx.rand(generator)
    lml = fx.logpdf(y)
    el = elbo(VFE(f(x, 1e-9)), fx, y)
    _close(el, lml, rtol=1e-5, atol=1e-5)
