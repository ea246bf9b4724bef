"""The port's conformance suites (``utils/test_utils.py``) on every concrete
GP type of the port, as ``tests/test_conformance.py`` runs the JAX
package's suites: the prior, the exact posterior, the VFE and DTC
posteriors, the SVGP, CG and Markov posteriors, at f64 on the CPU. The
last tier holds the analytic invariant ELBO(VFE(f(x, jitter)), fx, y) ≈
logpdf(fx, y).

A GP that breaks a contract must fail the suite: a posterior whose
``var`` disagrees with ``diag(cov)``, and one whose ELBO at inducing = data
drifts from the logpdf.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import abstractgps_tpu_torch as agt
from abstractgps_tpu_torch.models import svgp as tsv
from abstractgps_tpu_torch.ops import distance
from abstractgps_tpu_torch.utils.test_utils import (
    test_finitegp_primary_and_secondary_interface as check_finite,
)
from abstractgps_tpu_torch.utils.test_utils import (
    test_internal_abstractgps_interface as check_internal,
)

F64 = torch.float64


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


@pytest.fixture
def data(rng):
    x = torch.as_tensor(rng.uniform(size=(17, 2)) * 3.0, dtype=F64)
    z = torch.as_tensor(rng.uniform(size=(11, 2)) * 3.0, dtype=F64)
    return x, z, torch.Generator().manual_seed(42)


def test_prior_conformance(data):
    x, z, gen = data
    f = agt.GP(0.5, agt.with_lengthscale(agt.Matern52Kernel(), 0.8) * 1.3)
    check_internal(gen, f, x, z)


def test_exact_posterior_conformance(data):
    x, z, gen = data
    f = agt.GP(agt.with_lengthscale(agt.SEKernel(), 0.9))
    y = f(x, 0.1).rand(gen)
    check_internal(gen, agt.posterior(f(x, 0.1), y), x, z)


@pytest.mark.parametrize("approx_cls", [agt.VFE, agt.DTC])
def test_sparse_posterior_conformance(data, approx_cls):
    x, z, gen = data
    f = agt.GP(agt.Matern32Kernel())
    y = f(x, 0.1).rand(gen)
    post = agt.posterior(approx_cls(f(z, 1e-6)), f(x, 0.1), y)
    assert isinstance(post, agt.ApproxPosteriorGP)
    check_internal(gen, post, x, z)


def test_svgp_posterior_conformance(data):
    # the SVGP variational posterior is an AbstractGP too
    x, z, gen = data
    f = agt.GP(agt.Matern32Kernel())
    y = f(x, 0.1).rand(gen)
    sv = agt.svgp_init(agt.Matern32Kernel(), z, jitter=1e-8)
    sv = tsv.set_variational(sv, *tsv.optimal_variational_params(sv, x, y, 0.1))
    check_internal(gen, agt.svgp_posterior(sv), x, z)


def test_cg_posterior_conformance(data):
    # the matrix-free CG posterior passes the same internal suite as the
    # dense types (tests/test_conformance.py:76-84)
    x, z, gen = data
    f = agt.GP(agt.with_lengthscale(agt.Matern52Kernel(), 0.9))
    y = f(x, 0.1).rand(gen)
    post = agt.CGInference(max_iters=64).posterior(f(x, 0.1), y)
    assert isinstance(post, agt.CGPosteriorGP)
    check_internal(gen, post, x, z)


@pytest.fixture
def data_1d(rng):
    x = torch.as_tensor(np.sort(rng.uniform(size=17)) * 3.0, dtype=F64)[:, None]
    z = torch.as_tensor(rng.uniform(size=11) * 3.0, dtype=F64)[:, None]
    return x, z, torch.Generator().manual_seed(42)


@pytest.mark.parametrize("parallel", [False, True])
def test_markov_posterior_conformance(data_1d, parallel):
    # the state-space posterior (smoother-gain cross-covariances) passes the
    # same internal suite on a 1-D Matérn problem (tests/test_conformance.py:88-98)
    x, z, gen = data_1d
    f = agt.GP(1.3 * agt.with_lengthscale(agt.Matern32Kernel(), 0.8))
    y = f(x, 0.1).rand(gen)
    post = agt.markov_posterior(f(x, 0.1), y, parallel=parallel)
    assert isinstance(post, agt.MarkovPosteriorGP)
    check_internal(gen, post, x, z)


def test_markov_posterior_matches_dense(rng):
    # every surface of MarkovPosteriorGP equals the dense exact posterior
    # (tests/test_conformance.py:101-115)
    x = torch.as_tensor(np.sort(rng.uniform(size=23)) * 4.0, dtype=F64)[:, None]
    z = torch.as_tensor(rng.uniform(size=9) * 4.0, dtype=F64)[:, None]
    f = agt.GP(0.7 * agt.with_lengthscale(agt.Matern52Kernel(), 1.1))
    y = f(x, 0.3).rand(torch.Generator().manual_seed(1))
    dense = agt.posterior(f(x, 0.3), y)
    mk = agt.markov_posterior(f(x, 0.3), y)

    def close(a, b):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-8)

    close(mk.mean(z), dense.mean(z))
    close(mk.var(z), dense.var(z))
    close(mk.cov(z), dense.cov(z))
    close(mk.cov(z, x), dense.cov(z, x))
    m1, C1 = mk.mean_and_cov(z)
    m2, C2 = dense.mean_and_cov(z)
    close(m1, m2)
    close(C1, C2)


def test_finite_projection_of_sparse_posterior_conformance(data):
    x, z, gen = data
    f = agt.GP(agt.with_lengthscale(agt.SEKernel(), 0.7))
    y = f(x, 0.1).rand(gen)
    post = agt.posterior(agt.VFE(f(z, 1e-6)), f(x, 0.1), y)
    check_finite(gen, post(z, 1e-3), atol=1e-6)


class _BadVar(agt.AbstractGP):
    """A GP whose ``var`` is 10 % off ``diag(cov)``."""

    def __init__(self, f):
        self.f = f

    def mean(self, x):
        return self.f.mean(x)

    def cov(self, x, z=None):
        return self.f.cov(x, z)

    def var(self, x):
        return 1.1 * self.f.var(x)


class _BadElbo(agt.GP):
    """A prior whose projections carry twice their noise into ``f(x, σ²)``
    only when σ² is the tiny inducing jitter: every moment conforms, the
    ELBO at inducing = data does not."""

    def __call__(self, x, noise=None, obsdim=None):
        if noise is not None and float(noise) < 1e-6:
            noise = 0.5
        return super().__call__(x, noise, obsdim)


@pytest.mark.parametrize("bad", ["var", "elbo"])
def test_suite_rejects_a_broken_gp(data, bad):
    x, z, gen = data
    if bad == "var":
        f = _BadVar(agt.GP(agt.Matern32Kernel()))
    else:
        f = _BadElbo(agt.Matern32Kernel())
    with pytest.raises(AssertionError):
        check_internal(gen, f, x, z)
