"""The port's MLE-II training loops and parameter handling against the JAX
package's ``params`` and ``inference/training``.

- ``params``: the round trips of tests/test_params.py, and a tagged JAX
  tree carried across with ``params_from_numpy``.
- ``fit`` (``torch.optim.Adam``) against JAX ``fit`` (``optax.adam``) from
  the same θ₀ at f64 on the dense path: same defaults, same update, so the
  loss histories agree to 1e-6 relative over 20 steps.
- ``fit_lbfgs`` (``torch.optim.LBFGS``, strong Wolfe) reaches the JAX
  L-BFGS optimum within 1e-4; the line searches differ, so only the end
  points are compared.
- The history contract: length ``num_steps``, the unvisited tail backfilled
  with the final loss, a NaN met during the run left visible.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import param_tree

import abstractgps_tpu as agp
import abstractgps_tpu_torch as agt
from abstractgps_tpu import params as PJ
from abstractgps_tpu.inference import training as FJ
from abstractgps_tpu_torch import params as P
from abstractgps_tpu_torch.ops import distance


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


def _n(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def test_softplus_roundtrip():
    v = torch.tensor([0.01, 1.0, 5.0, 50.0], dtype=torch.float64)
    np.testing.assert_allclose(_n(P.softplus(P.inv_softplus(v))), _n(v), rtol=1e-12)


def test_positive_roundtrip():
    p = P.positive(2.5)
    assert p.raw.requires_grad and p.raw.is_leaf
    np.testing.assert_allclose(float(P.constrain(p).detach()), 2.5, rtol=1e-12)


def test_bounded_roundtrip():
    np.testing.assert_allclose(_n(P.constrain(P.bounded(0.3, 0.0, 1.0))), 0.3, rtol=1e-10)
    np.testing.assert_allclose(_n(P.constrain(P.bounded(-2.0, -5.0, 5.0))), -2.0,
                               rtol=1e-10)


def test_constrain_nested_tree():
    theta = {"kernel": {"ell": P.positive(1.5), "sigma": P.positive(0.5)},
             "noise": P.positive(0.1), "mean": P.real(3.0)}
    c = P.constrain(theta)
    np.testing.assert_allclose(_n(c["kernel"]["ell"]), 1.5, rtol=1e-10)
    np.testing.assert_allclose(_n(c["noise"]), 0.1, rtol=1e-10)
    np.testing.assert_allclose(_n(c["mean"]), 3.0)


def test_grad_flows_through_positive():
    theta = {"ell": P.positive(2.0)}
    loss = (P.constrain(theta)["ell"] - 1.0) ** 2
    (g,) = torch.autograd.grad(loss, [theta["ell"].raw])
    raw = theta["ell"].raw.detach()
    expect = 2.0 * (P.softplus(raw) - 1.0) * torch.sigmoid(raw)
    np.testing.assert_allclose(float(g), float(expect), rtol=1e-10)


def test_ravel_unravel():
    theta = {"a": P.positive(1.0), "b": P.real([1.0, 2.0])}
    flat, unravel = P.ravel(theta)
    assert flat.ndim == 1 and flat.shape[0] == 3
    back = unravel(flat)
    np.testing.assert_allclose(_n(P.constrain(back)["a"]), _n(P.constrain(theta)["a"]),
                               rtol=1e-12)
    np.testing.assert_allclose(_n(back["b"]), _n(theta["b"]))
    # the same flat order as the JAX package's ravel_pytree
    flat_j, _ = PJ.ravel({"a": PJ.positive(1.0), "b": PJ.real(jnp.array([1.0, 2.0]))})
    np.testing.assert_allclose(_n(flat), np.asarray(flat_j), rtol=1e-12)


def test_fixed_has_no_leaves():
    theta = {"a": P.positive(1.0), "b": P.fixed(7.0)}
    assert len(P.leaves(theta)) == 1
    np.testing.assert_allclose(float(P.constrain(theta)["b"]), 7.0)


def test_params_carried_across_from_jax():
    tj = {"ell": PJ.positive(1.5), "w": PJ.bounded(0.3, 0.0, 1.0), "c": PJ.fixed(2.0),
          "z": PJ.real(jnp.array([0.5, -1.0]))}
    tt = agt.params_from_numpy(param_tree(tj))
    cj, ct = PJ.constrain(tj), P.constrain(tt)
    for k in tj:
        np.testing.assert_allclose(_n(torch.as_tensor(ct[k])), np.asarray(cj[k]), rtol=1e-12)
    assert all(t.requires_grad for t in P.leaves(tt)) and len(P.leaves(tt)) == 3


# ---------------------------------------------------------------------------
# fit / fit_lbfgs against the JAX loops (dense f64 path)
# ---------------------------------------------------------------------------


def _data():
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(size=40) * 6.0)
    y = np.sin(x) + 0.2 * rng.normal(size=40)
    return x, y


def _theta0_jax():
    return {"ell": PJ.positive(1.0), "sigma2": PJ.positive(1.0), "noise2": PJ.positive(0.1)}


def _build_fx_jax(theta, x):
    k = theta["sigma2"] * agp.with_lengthscale(agp.Matern52Kernel(), theta["ell"])
    return agp.GP(k)(x, theta["noise2"])


def _build_fx(theta, x):
    k = theta["sigma2"] * agt.with_lengthscale(agt.Matern52Kernel(), theta["ell"])
    return agt.GP(k)(x, theta["noise2"])


@pytest.fixture(scope="module")
def jax_fits():
    x, y = _data()
    loss = FJ.nlml(_build_fx_jax, jnp.asarray(x), jnp.asarray(y))
    adam = FJ.fit(loss, _theta0_jax(), num_steps=20, learning_rate=5e-2)
    lb = FJ.fit_lbfgs(loss, _theta0_jax(), num_steps=200)
    return np.asarray(adam.history), lb, float(loss(lb.params))


def test_fit_adam_matches_jax(jax_fits):
    hist_j, _, _ = jax_fits
    x, y = _data()
    theta0 = agt.params_from_numpy(param_tree(_theta0_jax()))
    raw0 = [t.detach().clone() for t in P.leaves(theta0)]
    res = agt.fit(agt.nlml(_build_fx, torch.as_tensor(x), torch.as_tensor(y)), theta0,
                  num_steps=20, learning_rate=5e-2)
    assert res.history.shape == (20,)
    np.testing.assert_allclose(_n(res.history), hist_j, rtol=1e-6)
    # θ₀ is left as it was; the result is a tagged tree
    assert all(torch.equal(a, b) for a, b in zip(raw0, P.leaves(theta0)))
    assert isinstance(res.params["ell"], P.Positive)


def test_fit_lbfgs_matches_jax_optimum(jax_fits):
    _, lb_j, final_j = jax_fits
    x, y = _data()
    loss = agt.nlml(_build_fx, torch.as_tensor(x), torch.as_tensor(y))
    res = agt.fit_lbfgs(loss, agt.params_from_numpy(param_tree(_theta0_jax())), num_steps=200)
    assert res.history.shape == (200,) and torch.isfinite(res.history).all()
    np.testing.assert_allclose(float(loss(res.params).detach()), final_j, rtol=1e-4)
    cj, ct = PJ.constrain(lb_j.params), P.constrain(res.params)
    for k in ("ell", "sigma2", "noise2"):
        np.testing.assert_allclose(_n(ct[k]), float(cj[k]), rtol=1e-4)
    # a stationary point, as the JAX loop reaches
    g = torch.autograd.grad(loss(res.params), P.leaves(res.params))
    assert float(torch.linalg.vector_norm(torch.stack(g))) < 1e-3


def test_fit_lbfgs_backfills_the_unvisited_tail():
    # a quadratic converges in a few iterations; the rest of the history is
    # the final loss
    theta0 = {"a": P.real(0.0)}
    res = agt.fit_lbfgs(lambda t: (t["a"] - 3.0) ** 2, theta0, num_steps=50)
    h = _n(res.history)
    final = (float(res.params["a"].detach()) - 3.0) ** 2
    assert h.shape == (50,) and h[0] == 9.0
    n_iter = int(np.argmax(h == final)) if final in h else 50
    assert 1 < n_iter < 10 and np.all(h[n_iter:] == final)
    assert np.all(np.diff(h[:n_iter]) < 0)


def test_fit_lbfgs_keeps_a_nan_visible():
    # the loss is NaN exactly at a = 1 — the first trial point of the first
    # line search from a = 0 (step 1/|g| along −g) — and finite elsewhere:
    # the iteration records NaN, the parameters stay where it began, the run
    # ends, and the backfill does not paint over the NaN
    def loss(t):
        a = t["a"]
        poison = torch.where(torch.abs(a - 1.0) < 1e-12, math.nan, 0.0)
        return (a - 3.0) ** 2 + poison

    res = agt.fit_lbfgs(loss, {"a": P.real(0.0)}, num_steps=20)
    h = _n(res.history)
    assert np.isnan(h[0]) and np.all(h[1:] == 9.0)
    assert float(res.params["a"].detach()) == 0.0
    # a run that meets no NaN fills its whole history with finite losses
    res = agt.fit_lbfgs(lambda t: (t["a"] - 3.0) ** 2, {"a": P.real(0.5)}, num_steps=20)
    assert torch.isfinite(res.history).all()


def test_fit_history_stays_on_the_device_and_nan_stays():
    # fit writes each step's loss into a preallocated history; a NaN step
    # shows as NaN
    calls = {"n": 0}

    def loss(t):
        calls["n"] += 1
        bad = math.nan if calls["n"] == 3 else 0.0
        return (t["a"] - 3.0) ** 2 + bad

    res = agt.fit(loss, {"a": P.real(0.0)}, num_steps=5, learning_rate=0.1)
    h = _n(res.history)
    assert h.shape == (5,) and np.isnan(h[2]) and np.isfinite(np.delete(h, 2)).all()
    assert res.history.device == res.params["a"].device
