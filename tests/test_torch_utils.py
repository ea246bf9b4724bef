"""The port's utilities (``abstractgps_tpu_torch.utils``) case by case
against the JAX package's tests of its own (tests/test_checkpoint.py,
test_sanitizer.py, test_plotting.py): checkpoint round trips bit for bit,
the NaN trap and the non-finite guard, the plotting recipes under
matplotlib's Agg backend, and the profiling helpers."""

import json
import os

import matplotlib
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import abstractgps_tpu_torch as agt  # noqa: E402
from abstractgps_tpu_torch import params as P  # noqa: E402
from abstractgps_tpu_torch.inference.mcmc import MCMCResult  # noqa: E402
from abstractgps_tpu_torch.ops import distance  # noqa: E402
from abstractgps_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from abstractgps_tpu_torch.utils import profiling  # noqa: E402
from abstractgps_tpu_torch.utils.debug import checked, debug_mode  # noqa: E402
from abstractgps_tpu_torch.utils.plotting import plot_gp, sampleplot  # noqa: E402

F64 = torch.float64


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


@pytest.fixture
def sanitize():
    """The port's sanitizer fixture: the test body under ``debug_mode``."""
    with debug_mode():
        yield


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


# ---------------------------------------------------------------------------
# checkpoint (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------


def test_posterior_cache_roundtrip(tmp_path, rng):
    x = _t(rng.uniform(size=(20, 2)))
    f = agt.GP(agt.Matern32Kernel())
    y = f(x, 0.1).rand(torch.Generator().manual_seed(0))
    post = agt.posterior(f(x, 0.1), y)
    ckpt.save(str(tmp_path / "cache"), post.data)
    restored = ckpt.restore(str(tmp_path / "cache"), post.data)
    for name in ("alpha", "L", "x", "delta"):
        assert torch.equal(getattr(restored, name), getattr(post.data, name))
    assert torch.equal(restored.noise.variance, post.data.noise.variance)
    # a posterior rebuilt from the restored cache predicts identically
    post2 = agt.PosteriorGP(f, restored)
    assert torch.equal(post2.mean(x), post.mean(x))


def test_param_tree_roundtrip(tmp_path):
    theta = {"ell": P.positive(1.5), "z": P.real(torch.arange(6.0, dtype=F64).reshape(3, 2))}
    ckpt.save(str(tmp_path / "theta"), theta)
    back = ckpt.restore(str(tmp_path / "theta"), theta)
    np.testing.assert_allclose(float(P.constrain(back)["ell"]), 1.5, rtol=1e-12)
    assert torch.equal(back["z"], theta["z"]) and back["z"].requires_grad


def test_namedtuple_roundtrip_and_shape_mismatch(tmp_path):
    res = MCMCResult(*(torch.randn(2, 3, dtype=F64) for _ in range(5)),
                     step_size=torch.rand(2, dtype=F64), inv_mass=torch.rand(2, 3, dtype=F64))
    ckpt.save(str(tmp_path / "mcmc"), res)
    back = ckpt.restore(str(tmp_path / "mcmc"), res)
    assert isinstance(back, MCMCResult)
    assert all(torch.equal(a, b) for a, b in zip(back, res))
    # each leaf takes like's dtype; a leaf of another shape is refused
    like32 = res._replace(step_size=res.step_size.float())
    assert ckpt.restore(str(tmp_path / "mcmc"), like32).step_size.dtype == torch.float32
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path / "mcmc"), res._replace(inv_mass=torch.zeros(3, 3)))


# ---------------------------------------------------------------------------
# debug (tests/test_sanitizer.py)
# ---------------------------------------------------------------------------


def test_clean_flow_passes_under_sanitizer(sanitize, rng):
    x = _t(rng.uniform(size=(32, 2)))
    y = _t(rng.normal(size=(32,)))
    fx = agt.GP(agt.Matern52Kernel())(x, 0.1)
    lp = fx.logpdf(y)
    post = agt.posterior(fx, y)
    mu, var = post.mean_and_var(x[:8])
    assert np.isfinite(float(lp))
    assert torch.isfinite(mu).all()


def test_debug_mode_traps_nan():
    with debug_mode():
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0)) * 0.0 + torch.sqrt(torch.tensor(-1.0))
    # and it restores the previous state afterwards
    assert not torch.is_anomaly_enabled()
    assert float(torch.log(torch.tensor(-1.0)).isnan()) == 1.0


def test_checked_logpdf_raises_on_nonfinite_input(rng):
    x = _t(rng.uniform(size=(16, 1)))
    y = _t(rng.normal(size=(16,)))
    y[3] = float("nan")

    def logpdf(yy):
        return agt.GP(agt.SEKernel())(x, 0.1).logpdf(yy)

    with pytest.raises(Exception) as ei:
        checked(logpdf)(y)
    assert "nan" in str(ei.value).lower()
    # a clean input passes through with the same value
    y2 = _t(rng.normal(size=(16,)))
    assert float(checked(logpdf)(y2)) == float(logpdf(y2))


# ---------------------------------------------------------------------------
# plotting (tests/test_plotting.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def fx():
    x = torch.linspace(0.0, 5.0, 30, dtype=F64)
    return agt.GP(agt.Matern32Kernel())(x, 0.1)


def test_plot_gp_draws_mean_and_ribbon(fx):
    fig, ax = plt.subplots()
    plot_gp(fx, ax=ax, ribbon_scale=2.0)
    assert len(ax.lines) == 1
    assert len(ax.collections) == 1  # the ribbon
    np.testing.assert_allclose(ax.lines[0].get_ydata(), fx.mean().numpy(), atol=1e-6)
    plt.close(fig)


def test_plot_gp_rejects_negative_ribbon(fx):
    with pytest.raises(ValueError):
        plot_gp(fx, ribbon_scale=-1.0)


def test_plot_bare_gp_requires_x():
    f = agt.GP(agt.SEKernel())
    with pytest.raises(ValueError):
        plot_gp(f)
    fig, ax = plt.subplots()
    plot_gp(f, torch.linspace(0, 1, 5, dtype=F64), ax=ax)  # with x: ok (1e-9 jitter)
    plt.close(fig)


def test_sampleplot_nan_separated(fx):
    fig, ax = plt.subplots()
    sampleplot(fx, generator=42, samples=4, ax=ax)
    y = ax.lines[0].get_ydata()
    # one NaN separator per sample, 30 points each
    assert y.shape[0] == 4 * 31
    assert np.isnan(y[30]) and np.isnan(y[-1])
    assert np.isfinite(y[:30]).all()
    plt.close(fig)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_roofline_arithmetic():
    assert profiling.cholesky_flops(6) == 72.0
    r = profiling.roofline(67e12, 2.0)
    assert r.achieved == 33.5e12 and r.peak == profiling.H100_PEAK_F32
    assert r.fraction_of_peak == 0.5
    assert "50.0%" in str(r)


def test_timed_on_cpu_and_trace_writes_a_file(tmp_path):
    out = {}
    with profiling.timed(out, "t"):
        torch.ones(100).sum()
    assert out["t"] > 0.0
    with profiling.trace(str(tmp_path / "prof")):
        torch.randn(64, 64) @ torch.randn(64, 64)
    path = tmp_path / "prof" / "trace.json"
    assert os.path.getsize(path) > 0
    assert "traceEvents" in json.loads(path.read_text())


def test_port_imports_no_orbax_optax_and_matplotlib_only_in_plotting_functions():
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    files = sorted((root / "abstractgps_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    for f in files:
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in names:
                top = mod.split(".")[0]
                assert top not in ("orbax", "optax"), (f, mod)
                if top == "matplotlib":
                    assert f.name == "plotting.py", (f, mod)
        # in plotting.py, matplotlib only inside functions, never at import
        if f.name == "plotting.py":
            for node in tree.body:
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    mod = node.names[0].name if isinstance(node, ast.Import) else node.module
                    assert not mod.startswith("matplotlib"), mod
