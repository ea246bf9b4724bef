"""The port's parallel layer (``abstractgps_tpu_torch.parallel``) and the
samplers' ``mesh`` arguments, in gloo worlds of CPU processes.

The JAX tests run in one process on 8 virtual CPU devices; torch has no
counterpart, so this module spawns ONE world of 4 processes, which runs
every check of tests/test_parallel.py, test_sharded_samplers.py and
test_scaling_structure.py (tests/torch_parallel_worker.py), and one world
of 2 processes joined from torch's launcher variables, which runs the
three workloads of tests/multihost_worker.py. The 4-rank world meets
through a file store under ``tmp_path``, so parallel test files cannot
collide; both the process group and the join time out after 120 s. The
workers write their numbers to files, and each check below is a test of
its own that reads them. The JAX references are computed here, at f64,
from the same numpy inputs.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401

import abstractgps_tpu as agp

_WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
TIMEOUT = 120


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _join(procs, d, which, n):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out in outs:
        assert rc == 0, f"a rank failed (rc={rc}):\n{out[-4000:]}"
    results = []
    for r in range(n):
        with open(os.path.join(d, f"{which}_rank{r}.json")) as fh:
            results.append(json.load(fh))
    return results


def _inputs(d):
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(256, 2)) * 4.0
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.2 * rng.normal(size=256)
    xl = rng.uniform(size=(64, 2)) * 4.0
    yl = rng.normal(size=64)
    particles = rng.normal(size=(1024, 2))
    np.savez(os.path.join(d, "inputs.npz"), x=x, y=y, z=x[::16], z0=x[::16], xl=xl, yl=yl,
             particles=particles)
    return dict(x=x, y=y, z=x[::16], xl=xl, yl=yl)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, the 4 ranks' results, the 2 ranks' results)."""
    d = str(tmp_path_factory.mktemp("gloo"))
    inp = _inputs(d)
    procs = [subprocess.Popen([sys.executable, "-u", _WORKER, "world4", str(r), "4", d],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=_env()) for r in range(4)]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs2 = []
    for r in range(2):
        env = dict(_env(), MASTER_ADDR="localhost", MASTER_PORT=port, RANK=str(r),
                   WORLD_SIZE="2", LOCAL_RANK=str(r))
        procs2.append(subprocess.Popen([sys.executable, "-u", _WORKER, "world2", d],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True, env=env))
    try:
        w4 = _join(procs, d, "world4", 4)
    finally:
        w2 = _join(procs2, d, "world2", 2)
    return inp, w4, w2


def _total(counts):
    return sum(counts["layer"].values()), sum(counts["raw"].values())


# ---------------------------------------------------------------------------
# tests/test_parallel.py
# ---------------------------------------------------------------------------


def test_mesh_shapes(world):
    _, w4, _ = world
    for r, res in enumerate(w4):
        m = res["mesh"]
        assert m["shape"] == [4] and m["names"] == ["dp"]
        assert m["shape2"] == [2, 2] and m["names2"] == ["dp", "tp"]
        assert m["coord2"] == [r // 2, r % 2]  # process-major
        assert m["pod"] == [1, 4]  # one host: tp takes every rank
        assert all(m["raises"]), m["raises"]
        assert m["distributed"] == [True, r, 4]


def test_sharded_elbo_matches_unsharded(world):
    inp, w4, _ = world
    x, y, z = (jnp.asarray(inp[k]) for k in ("x", "y", "z"))

    def loss(ell):
        f_ = agp.GP(agp.with_lengthscale(agp.SEKernel(), ell))
        return -agp.elbo(agp.VFE(f_(z, 1e-6)), f_(x, 0.05), y)

    want = -float(loss(0.7))
    want_g = -float(jax.grad(loss)(0.7))
    vals = {res["elbo"]["value"] for res in w4}
    assert len(vals) == 1  # every rank holds the same global value
    for res in w4:
        e = res["elbo"]
        np.testing.assert_allclose(e["value"], want, rtol=1e-10)
        np.testing.assert_allclose(e["grad_ell"], want_g, rtol=1e-8)
        # one packed all-reduce forward, one in the backward, one to average ∇ℓ;
        # O(m²) bytes: m = 16 → (16² + 16 + 5) f64
        assert e["counts"]["layer"] == {"all_reduce": 3, "all_gather": 0, "broadcast": 0}
        assert e["counts"]["raw"]["all_reduce"] == 3 and _total(e["counts"])[1] == 3
        assert e["bytes"]["all_reduce"] == 8 * (2 * (16 * 16 + 16 + 5) + 1)
        # outside the data axis: the shard's own bound, and no collective
        assert _total(e["unsharded_counts"]) == (0, 0) and e["local_differs"]


def test_sharded_logpdf_matches(world):
    inp, w4, _ = world
    want = float(agp.GP(agp.Matern32Kernel())(jnp.asarray(inp["xl"]), 0.1)
                 .logpdf(jnp.asarray(inp["yl"])))
    for res in w4:
        assert res["logpdf"]["bitwise"]  # gathered shards give back the exact logpdf
        np.testing.assert_allclose(res["logpdf"]["value"], want, rtol=1e-10)


def test_fit_sharded_runs_and_improves(world):
    _, w4, _ = world
    ref = np.asarray(w4[0]["fit"]["unsharded"])
    for res in w4:
        h = np.asarray(res["fit"]["history"])
        assert h.shape == (60,) and np.isfinite(h).all()
        assert h[-1] < h[0]
        np.testing.assert_allclose(h, ref, rtol=1e-8)
        assert res["fit"]["history"] == w4[0]["fit"]["history"]  # replicated θ
        # a step: 3 all-reduces of O(m²); θ broadcast once (4 leaves)
        assert res["fit"]["counts"]["layer"] == {"all_reduce": 180, "all_gather": 0,
                                                 "broadcast": 4}


def test_replicated_bound_inside_fit_sharded_counts_once(world):
    # a bound of replicated data inside data_axis(None) adds its value once,
    # not once a rank: the sharded history equals the unsharded fit's
    _, w4, _ = world
    for res in w4:
        r = res["replicated"]
        np.testing.assert_allclose(r["history"], r["unsharded"], rtol=1e-8)


def test_collapsed_bound_raises_on_data_that_is_no_shard(world):
    _, w4, _ = world
    for res in w4:
        # replicated x, y and a shard's derived copy raise; one marked input sums
        assert res["replicated"]["raises"] == [True, True, True]


def test_replicate_shard_along_and_host_local_array(world):
    _, w4, _ = world
    g = np.arange(24.0).reshape(8, 3)
    for r, res in enumerate(w4):
        m = res["misc"]
        assert m["replicated"] == [[0.0, 0.0, 0.0], 0.5]
        np.testing.assert_array_equal(m["shard_rows"], g[2 * r:2 * r + 2])
        np.testing.assert_array_equal(m["shard_cols"], [[2.0 * r, 2.0 * r + 1]])
        np.testing.assert_array_equal(m["tp_rows"], g[4 * (r % 2):4 * (r % 2) + 4])
        assert m["shard_raises"]
        np.testing.assert_array_equal(m["host_local"], g[2 * r:2 * r + 2])
        assert all(m["host_local_raises"])


# ---------------------------------------------------------------------------
# tests/test_sharded_samplers.py and tests/test_scaling_structure.py
# ---------------------------------------------------------------------------


def test_sharded_nuts_matches_unsharded(world):
    _, w4, _ = world
    for res in w4:
        # each chain's random numbers are its own: the draws are equal
        assert res["nuts"]["per_chain_equal"]
        assert res["nuts"]["chains"] == [2, 40, 3]
    # the default generator: every rank draws the full batch and keeps its
    # chains', but a NUTS tree draws while any of its batch's chains is
    # active, so the streams diverge and the chains agree in distribution
    # only: the JAX test's moment tolerances; the adapted step sizes spread
    # ~0.13 from chain to chain, so their mean over the 8 chains is held
    # within 0.1 relative (~2 standard errors)
    got, ref = w4[0]["nuts"]["default"], w4[0]["nuts"]["default_unsharded"]
    np.testing.assert_allclose(got["mean"], ref["mean"], atol=0.15)
    np.testing.assert_allclose(got["var"], ref["var"], atol=0.3)
    np.testing.assert_allclose(np.mean(got["step"]), np.mean(ref["step"]), rtol=0.1)


def test_sharded_smc_runs(world):
    _, w4, _ = world
    post_var = 1.0 / (1.0 + 2.0)
    post_mean = post_var * np.array([0.5, -0.3]) / 0.5
    for res in w4:
        s = res["smc"]
        np.testing.assert_allclose(s["mean"], post_mean, atol=0.1)
        np.testing.assert_allclose(s["var"], post_var, atol=0.1)
        # the same draws as the unsharded run: the same particles
        assert s["max_diff_unsharded"] < 1e-12
        np.testing.assert_allclose(s["log_z"][0], s["log_z"][1], rtol=1e-12)


def test_nuts_and_ess_chain_sharded_run_zero_collectives(world):
    _, w4, _ = world
    for res in w4:
        assert _total(res["nuts"]["counts"]) == (0, 0)  # warmup included
        assert _total(res["ess"]["counts"]) == (0, 0)
        assert res["ess"]["shape"] == [2, 8, 4] and res["ess"]["finite"]
        assert res["ess"]["std"] > 1e-3


def test_smc_sharded_collectives_bounded(world):
    _, w4, _ = world
    for res in w4:
        per = {}
        for n_p, r in res["smc"]["per_stage"].items():
            layer, raw = _total(r["counts"])
            assert layer == raw and r["counts"]["raw"]["all_to_all"] == 0
            assert r["counts"]["layer"]["all_gather"] == 2 * r["stages"]
            per[n_p] = layer / r["stages"]
        # per tempering stage: 2 all-gathers and 1 all-reduce, whatever N is
        assert per["64"] == per["256"] == 3


# ---------------------------------------------------------------------------
# tests/test_multihost.py, at world size 2 from the launcher variables
# ---------------------------------------------------------------------------


def test_two_process_workloads_from_environment(world):
    _, _, (r0, r1) = world
    assert r0 == r1  # both ranks computed identical global results
    assert r0["world"] == [True, 2]
    assert r0["fit_loss"] < 0.5
    np.testing.assert_allclose(r0["nuts_mean"], [0.0, 0.0, 0.0], atol=0.35)
    np.testing.assert_allclose(r0["nuts_var"], [1.0, 4.0, 0.25], rtol=0.5)


def test_two_process_tp_sharded_logpdf(world):
    # tests/multihost_worker.py's third workload: make_pod_mesh(("tp",)),
    # block 8, against the dense logpdf
    _, _, (r0, r1) = world
    assert r0["sharded_logpdf"] == r1["sharded_logpdf"]
    np.testing.assert_allclose(r0["sharded_logpdf"], r0["dense_logpdf"], rtol=1e-10)
