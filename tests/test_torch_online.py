"""The port's streaming exact conditioning (``models/online.py``) against the
JAX package and against the oracles of ``tests/test_online.py``: the padded
fixed-capacity cache equals batch conditioning, and an extend past the
capacity poisons every later mean and variance with NaN.

``test_online_compiles_once_under_scan`` and
``test_online_prior_is_traced_not_static`` of the JAX tests check that XLA
does not retrace the streaming program, which eager torch does not have;
their counterparts here hold the rest of what they check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import kernel_tree, small_kernel_paths

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu.models import online as jon
from abstractgps_tpu_torch.models import online as ton
from abstractgps_tpu_torch.ops import blocked_chol, distance, fused_gram

F64 = torch.float64


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


def _n(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _stream(lib_online, lib, kernel, x, y, cap, b, noise, to):
    f = lib.GP(kernel)
    state = (lib_online.online_init(f, capacity=cap, input_dim=x.shape[1], dtype=to["dtype"])
             if lib is agp else lib_online.online_init(f, capacity=cap, input_dim=x.shape[1],
                                                       dtype=to["dtype"], device="cpu"))
    for i in range(0, x.shape[0], b):
        state = lib_online.online_extend(state, to["arr"](x[i:i + b]), to["arr"](y[i:i + b]),
                                         noise)
    return f, state


JAX64 = {"dtype": jnp.float64, "arr": jnp.asarray}
TORCH64 = {"dtype": F64, "arr": _t}


def test_online_matches_batch_and_jax(rng):
    n, b, d = 32, 8, 2
    x = rng.uniform(size=(n, d))
    y = rng.normal(size=n)
    x_test = rng.uniform(size=(10, d))
    f, state = _stream(ton, agt, agt.Matern52Kernel(), x, y, 64, b, 0.1, TORCH64)
    mu_o, var_o = ton.online_mean_and_var(state, _t(x_test))
    mu_b, var_b = agt.posterior(f(_t(x), 0.1), _t(y)).mean_and_var(_t(x_test))
    np.testing.assert_allclose(_n(mu_o), _n(mu_b), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(_n(var_o), _n(var_b), rtol=1e-7, atol=1e-8)
    assert int(state.count) == n
    # the padded cache: identity beyond count, α and δ zero there
    L = _n(state.L)
    np.testing.assert_array_equal(L[n:, n:], np.eye(64 - n))
    np.testing.assert_array_equal(L[n:, :n], 0.0)
    assert not _n(state.alpha)[n:].any() and not _n(state.delta)[n:].any()
    # against the JAX package's cache and prediction
    _, sj = _stream(jon, agp, agp.Matern52Kernel(), x, y, 64, b, 0.1, JAX64)
    for name in ("L", "alpha", "delta", "x"):
        np.testing.assert_allclose(_n(getattr(state, name)), np.asarray(getattr(sj, name)),
                                   rtol=1e-10, atol=1e-12)
    mj, vj = jon.online_mean_and_var(sj, jnp.asarray(x_test))
    np.testing.assert_allclose(_n(mu_o), np.asarray(mj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_n(var_o), np.asarray(vj), rtol=1e-10, atol=1e-12)


def test_online_stream_with_predictions_between_extends(rng):
    # the JAX test runs this loop as one compiled scan (the retrace check);
    # here the loop itself: predictions between extends, the last against
    # batch, variances shrink over the stream
    n, b, d = 48, 8, 1
    x = np.sort(rng.uniform(size=n))[:, None]
    y = np.sin(6 * x[:, 0]) + 0.05 * rng.normal(size=n)
    f = agt.GP(agt.SEKernel())
    state = ton.online_init(f, capacity=n, input_dim=d, dtype=F64, device="cpu")
    ms, vs = [], []
    for i in range(0, n, b):
        state = ton.online_extend(state, _t(x[i:i + b]), _t(y[i:i + b]), 0.05)
        m, v = ton.online_mean_and_var(state, _t(x[:4]))
        ms.append(_n(m))
        vs.append(_n(v))
    mu_b, var_b = agt.posterior(f(_t(x), 0.05), _t(y)).mean_and_var(_t(x[:4]))
    np.testing.assert_allclose(ms[-1], _n(mu_b), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(vs[-1], _n(var_b), rtol=1e-6, atol=1e-8)
    assert np.isfinite(np.asarray(ms)).all()
    assert float(vs[0].mean()) >= float(vs[-1].mean()) - 1e-9


def test_online_extend_past_capacity_poisons(rng):
    # overflow must NOT silently clamp-overwrite valid rows: the cache
    # NaN-poisons so downstream predictions are visibly invalid; the write
    # itself stays inside the buffers (start clamped to cap − b)
    x = rng.uniform(size=(12, 1))
    y = np.sin(x[:, 0])
    f = agt.GP(agt.Matern32Kernel())
    st = ton.online_init(f, capacity=8, input_dim=1, dtype=F64, device="cpu")
    st = ton.online_extend(st, _t(x[:8]), _t(y[:8]), 0.1)
    m0, _ = ton.online_mean_and_var(st, _t(x[:2]))
    assert bool(torch.isfinite(m0).all())
    st = ton.online_extend(st, _t(x[8:]), _t(y[8:]), 0.1)  # 12 > capacity 8
    m1, v1 = ton.online_mean_and_var(st, _t(x[:2]))
    assert bool(torch.isnan(m1).all()) and bool(torch.isnan(v1).all()), (m1, v1)
    assert int(st.count) == 12 and st.L.shape == (8, 8)
    # a later extend stays poisoned
    st = ton.online_extend(st, _t(x[:2]), _t(y[:2]), 0.1)
    assert bool(torch.isnan(ton.online_mean_and_var(st, _t(x[:2]))[0]).all())


@pytest.mark.parametrize("s2", [1.0, 2.5])
def test_online_prior_hyperparameters_match_jax(rng, s2):
    # the JAX test checks that two prior variances share one compiled
    # program; here the same two priors against the JAX package's results
    x = rng.uniform(size=(6, 1))
    y = np.sin(x[:, 0])
    kt = agt.Matern32Kernel() * torch.tensor(s2, dtype=F64)
    kj = agp.Matern32Kernel() * jnp.float64(s2)
    _, st = _stream(ton, agt, kt, x, y, 8, 6, 0.1, TORCH64)
    _, sj = _stream(jon, agp, kj, x, y, 8, 6, 0.1, JAX64)
    m, v = ton.online_mean_and_var(st, _t(x[:2]))
    mj, vj = jon.online_mean_and_var(sj, jnp.asarray(x[:2]))
    assert bool(torch.isfinite(m).all())
    np.testing.assert_allclose(_n(m), np.asarray(mj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_n(v), np.asarray(vj), rtol=1e-10, atol=1e-12)


def test_online_from_numpy_carries_the_cache(rng):
    x = rng.uniform(size=(10, 2))
    y = rng.normal(size=10)
    _, sj = _stream(jon, agp, agp.Matern52Kernel(), x, y, 16, 5, 0.1, JAX64)
    tree = {"prior": {"kernel": kernel_tree(sj.prior.kernel), "mean": {"type": "ZeroMean"}},
            **{k: np.asarray(getattr(sj, k)) for k in ("L", "alpha", "delta", "x")},
            "count": int(sj.count)}
    st = agt.convert.online_from_numpy(tree)
    assert st.L.device.type == "cpu" and int(st.count) == 10
    x_test = rng.uniform(size=(4, 2))
    m, v = ton.online_mean_and_var(st, _t(x_test))
    mj, vj = jon.online_mean_and_var(sj, jnp.asarray(x_test))
    np.testing.assert_allclose(_n(m), np.asarray(mj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_n(v), np.asarray(vj), rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# f32 through the kernel paths (interpret mode, small sizes): the cache of
# capacity 64 takes the fused gram and the wide solve (tri_inv_block)
# ---------------------------------------------------------------------------

OCAP, OB, OD = 64, 32, 3


def _online_data():
    rng = np.random.default_rng(9)
    x = rng.uniform(size=(OCAP, OD)).astype(np.float32)
    y = rng.normal(size=OCAP).astype(np.float32)
    x_test = rng.uniform(size=(40, OD)).astype(np.float32)
    return x, y, x_test


@pytest.fixture(scope="module")
def jax_online_f32():
    x, y, x_test = _online_data()
    with small_kernel_paths():
        _, sj = _stream(jon, agp, agp.Matern32Kernel(), x, y, OCAP, OB, jnp.float32(0.1),
                        {"dtype": jnp.float32, "arr": jnp.asarray})
        m, v = jon.online_mean_and_var(sj, jnp.asarray(x_test))
    return np.asarray(m), np.asarray(v), np.asarray(sj.L)


def test_online_kernel_path_f32_matches_jax(jax_online_f32, monkeypatch):
    # tolerance: f32 with sums in another order, κ(K + 0.1·I) ≲ 7e2 here:
    # 1e-4 of the largest entry
    x, y, x_test = _online_data()
    calls = {"gram_tile": 0, "tri_inv_block": 0}
    for mod, name in ((fused_gram, "gram_tile"), (blocked_chol, "tri_inv_block")):
        orig = getattr(mod, name)

        def spy(*a, _o=orig, _n=name):
            calls[_n] += 1
            return _o(*a)

        monkeypatch.setattr(mod, name, spy)
    with small_kernel_paths():
        _, st = _stream(ton, agt, agt.Matern32Kernel(), x, y, OCAP, OB, torch.tensor(0.1),
                        {"dtype": torch.float32, "arr": torch.as_tensor})
        m, v = ton.online_mean_and_var(st, torch.as_tensor(x_test))
    mj, vj, Lj = jax_online_f32
    assert m.dtype == torch.float32
    # per extend: the cross gram against the cache and the block's gram; the
    # prediction's cross gram; the wide solves' batched block inverses
    assert calls["gram_tile"] == 2 * (OCAP // OB) + 1
    assert calls["tri_inv_block"] == OCAP // OB + 1
    np.testing.assert_allclose(_n(st.L), Lj, atol=1e-4 * np.abs(Lj).max())
    np.testing.assert_allclose(_n(m), mj, atol=1e-4 * np.abs(mj).max())
    np.testing.assert_allclose(_n(v), vj, atol=1e-4 * np.abs(vj).max())
