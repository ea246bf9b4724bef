"""One rank of the gloo worlds of tests/test_torch_parallel.py and
tests/test_torch_sharded_linalg.py.

``python torch_parallel_worker.py world4 RANK WORLD DIR`` joins a world
through a file store under DIR and runs every check of the 4-rank world;
``python torch_parallel_worker.py tp4 RANK WORLD DIR`` likewise runs the
tensor-parallel linear algebra's cases; ``python torch_parallel_worker.py
world2 DIR`` joins from torch's launcher variables (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT) and runs the multihost worker's three workloads.
Inputs come from DIR/inputs.npz; each rank writes its numbers to
DIR/<world>_rank<r>.json (and tp4 its arrays to DIR/tp4_rank<r>.npz).
Port-only: no JAX.
"""

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import abstractgps_tpu_torch as agt  # noqa: E402
from abstractgps_tpu_torch import params as P  # noqa: E402
from abstractgps_tpu_torch.inference.mcmc import (  # noqa: E402
    init_chain_positions,
    run_ess,
    run_mcmc,
    run_smc,
)
from abstractgps_tpu_torch.ops import distance  # noqa: E402
from abstractgps_tpu_torch.parallel import (  # noqa: E402
    collectives,
    fit_sharded,
    host_local_array,
    initialize_distributed,
    is_distributed,
    make_mesh,
    make_pod_mesh,
    replicate,
    shard_along,
)
from abstractgps_tpu_torch.parallel import sharded_linalg as sl  # noqa: E402
from abstractgps_tpu_torch.parallel.data_parallel import psum  # noqa: E402
from abstractgps_tpu_torch.parallel.multihost import num_processes, process_index  # noqa: E402

F64 = torch.float64
TIMEOUT = 120.0
RAW = ("all_reduce", "all_gather", "broadcast", "all_to_all", "all_to_all_single",
       "reduce_scatter", "reduce_scatter_tensor", "all_gather_into_tensor", "gather",
       "scatter", "reduce", "send", "recv", "isend", "irecv")
RAW_COUNTS = dict.fromkeys(RAW, 0)


def _count_raw_collectives():
    """Count every torch.distributed collective, the layer's and any other."""
    for name in RAW:
        orig = getattr(dist, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            RAW_COUNTS[_name] += 1
            return _orig(*a, **k)

        setattr(dist, name, wrapped)


def _reset():
    collectives.reset_collectives()
    for k in RAW_COUNTS:
        RAW_COUNTS[k] = 0


def _counts():
    return {"layer": dict(collectives.COLLECTIVES), "raw": dict(RAW_COUNTS)}


def _raises(fn, exc=ValueError):
    try:
        fn()
    except exc:
        return True
    return False


class PerChainDraws:
    """NUTS draws with one generator a chain: a chain draws only while it
    is active, so its stream does not depend on the other chains."""

    def __init__(self, seed, n):
        self.gens = [torch.Generator().manual_seed(seed * 1000 + c) for c in range(n)]

    def momentum(self, q):
        return torch.stack([torch.randn(q.shape[1], generator=g, dtype=q.dtype)
                            for g in self.gens])

    def _uniform(self, q, active):
        return torch.tensor([float(torch.rand((), generator=g, dtype=q.dtype)) if a else 0.5
                             for g, a in zip(self.gens, active.tolist())], dtype=q.dtype)

    def direction(self, q, active):
        return self._uniform(q, active) < 0.5

    def leaf_uniform(self, q, active):
        return self._uniform(q, active)

    def bias_uniform(self, q, active):
        return self._uniform(q, active)


def std_normal(q):
    return -0.5 * torch.sum(q * q)


# ---------------------------------------------------------------------------
# the 4-rank world
# ---------------------------------------------------------------------------


def elbo_loss(theta, data, z):
    x_, y_ = data
    kern = theta["sigma2"] * agt.with_lengthscale(agt.SEKernel(), theta["ell"])
    f = agt.GP(kern)
    return -agt.elbo(agt.VFE(f(theta["z"] if z is None else z, 1e-6)), f(x_, theta["noise2"]),
                     y_)


def world4(rank, world, d):
    inp = np.load(os.path.join(d, "inputs.npz"))
    out = {}
    # -- meshes -------------------------------------------------------------
    mesh = make_mesh(4)
    mesh2 = make_mesh(4, ("dp", "tp"), (2, 2))
    pod = make_pod_mesh(("dp", "tp"))
    out["mesh"] = {
        "shape": list(mesh.mesh.shape), "names": list(mesh.mesh_dim_names),
        "shape2": list(mesh2.mesh.shape), "names2": list(mesh2.mesh_dim_names),
        "coord2": list(mesh2.get_coordinate()),
        "pod": list(pod.mesh.shape),
        "raises": [_raises(lambda: make_mesh(4, ("dp",), (2, 2))),
                   _raises(lambda: make_mesh(4, ("dp", "tp"), (3, 2))),
                   _raises(lambda: make_mesh(2)),
                   _raises(lambda: make_pod_mesh(("dp", "tp"), tp=3))],
        "distributed": [is_distributed(), process_index(), num_processes()],
    }
    # -- replicate, shard_along, host_local_array -------------------------------
    tree = {"a": torch.full((3,), float(rank), dtype=F64), "b": [torch.tensor(rank + 0.5)]}
    rep = replicate(tree, mesh)
    g = torch.arange(24.0, dtype=F64).reshape(8, 3)
    hl = host_local_array((8, 3), mesh, 0, g[2 * rank:2 * rank + 2].numpy())
    out["misc"] = {
        "replicated": [rep["a"].tolist(), float(rep["b"][0])],
        "shard_rows": shard_along(g, mesh).tolist(),
        "shard_cols": shard_along(torch.arange(8.0).reshape(1, 8), mesh, dim=1).tolist(),
        "tp_rows": shard_along(g, mesh2, "tp").tolist(),
        "shard_raises": _raises(lambda: shard_along(torch.zeros(6, 2), mesh)),
        "host_local": hl.tolist(),
        "host_local_raises": [
            _raises(lambda: host_local_array((8, 3), mesh, 0, np.zeros((3, 3)))),
            _raises(lambda: host_local_array((6, 3), mesh, 0, np.zeros((2, 3))))],
    }
    group = mesh.get_group("dp")
    x, y, z = (torch.as_tensor(inp[k]) for k in ("x", "y", "z"))
    # -- the sharded collapsed ELBO and its ∇ℓ ---------------------------------
    ell = torch.tensor(0.7, dtype=F64, requires_grad=True)
    theta = {"sigma2": torch.tensor(1.0, dtype=F64), "ell": ell, "noise2": 0.05}
    _reset()
    with collectives.data_axis(group):
        val = elbo_loss(theta, (shard_along(x, mesh), shard_along(y, mesh)), z)
    (gl,) = torch.autograd.grad(val, ell)
    gl = collectives.all_reduce(gl.clone(), group) / world
    out["elbo"] = {"value": -float(val), "grad_ell": -float(gl), "counts": _counts(),
                   "bytes": dict(collectives.COLLECTIVE_BYTES)}
    # outside the data axis the same call takes no collective
    _reset()
    local = elbo_loss(theta, (shard_along(x, mesh), shard_along(y, mesh)), z)
    out["elbo"]["unsharded_counts"] = _counts()
    out["elbo"]["local_differs"] = float(local) != float(val)
    # -- the exact logpdf from gathered shards, bit for bit ----------------------
    xl, yl = inp["xl"], inp["yl"]
    xs = collectives.all_gather(shard_along(torch.as_tensor(xl), mesh), group)
    ys = collectives.all_gather(shard_along(torch.as_tensor(yl), mesh), group)
    f = agt.GP(agt.Matern32Kernel())
    lp = float(f(xs, 0.1).logpdf(ys))
    out["logpdf"] = {"value": lp,
                     "bitwise": lp == float(f(torch.as_tensor(xl), 0.1).logpdf(torch.as_tensor(yl)))}
    # -- fit_sharded against the unsharded fit ---------------------------------
    raw = {"ell": P.positive(1.0), "sigma2": P.positive(1.0), "noise2": P.positive(0.1),
           "z": P.real(torch.as_tensor(inp["z0"]))}

    def loss_raw(rt, data):
        return elbo_loss(P.constrain(rt), data, None)

    _reset()
    t0 = time.perf_counter()
    res = fit_sharded(loss_raw, raw, (x, y), mesh, num_steps=60, learning_rate=5e-2)
    out["fit"] = {"history": res.history.tolist(), "counts": _counts(),
                  "seconds": time.perf_counter() - t0,
                  "ell": float(P.constrain(res.params)["ell"])}
    if rank == 0:
        ref = agt.fit(lambda rt: loss_raw(rt, (x, y)), raw, num_steps=60, learning_rate=5e-2)
        out["fit"]["unsharded"] = ref.history.tolist()
    # -- a bound of replicated data inside fit_sharded ----------------------------
    # the loss adds the collapsed bound of the 64 replicated points of the
    # logpdf check, inside data_axis(None): counted once, as unsharded
    xr, yr = torch.as_tensor(inp["xl"]), torch.as_tensor(inp["yl"])

    def loss_rep(rt, data):
        with collectives.data_axis(None):
            rep = elbo_loss(P.constrain(rt), (xr, yr), None)
        return loss_raw(rt, data) + rep

    res = fit_sharded(loss_rep, raw, (x, y), mesh, num_steps=3, learning_rate=5e-2)
    ref = agt.fit(lambda rt: loss_rep(rt, (x, y)), raw, num_steps=3, learning_rate=5e-2)
    out["replicated"] = {"history": res.history.tolist(),
                         "unsharded": ref.history.tolist()}
    # data that is no shard of the active axis raises: replicated data, a
    # tensor derived from a shard inside the loss; the shards themselves sum
    xs_, ys_ = shard_along(x, mesh), shard_along(y, mesh)
    with collectives.data_axis(group):
        out["replicated"]["raises"] = [
            _raises(lambda: elbo_loss(theta, (x, y), z)),
            _raises(lambda: elbo_loss(theta, (xs_ * 1.0, ys_ * 1.0), z)),
            not _raises(lambda: elbo_loss(theta, (xs_, ys_ * 1.0), z))]
    # -- chain-sharded NUTS -----------------------------------------------------
    init = init_chain_positions(1, torch.zeros(3, dtype=F64), num_chains=8)
    kw = dict(num_samples=40, num_warmup=40, num_chains=8, max_depth=6)
    _reset()
    r1 = run_mcmc(std_normal, init, PerChainDraws(5, 8), mesh=mesh, **kw)
    out["nuts"] = {"counts": _counts()}
    r0 = run_mcmc(std_normal, init, PerChainDraws(5, 8), **kw)
    lo, hi = 2 * rank, 2 * rank + 2
    out["nuts"]["per_chain_equal"] = (torch.equal(r1.positions, r0.positions[lo:hi])
                                      and torch.equal(r1.step_size, r0.step_size[lo:hi]))
    out["nuts"]["chains"] = list(r1.positions.shape)
    # the default generator: every rank draws the full batch, streams diverge
    kw_d = dict(num_samples=100, num_warmup=100, num_chains=8)
    rd = run_mcmc(std_normal, init, 11, mesh=mesh, **kw_d)
    q1 = collectives.all_gather(rd.positions, group).reshape(-1, 3)
    s1 = collectives.all_gather(rd.step_size, group)
    out["nuts"]["default"] = {"mean": q1.mean(0).tolist(), "var": q1.var(0).tolist(),
                              "step": s1.tolist()}
    if rank == 0:
        ru = run_mcmc(std_normal, init, 11, **kw_d)
        qu = ru.positions.reshape(-1, 3)
        out["nuts"]["default_unsharded"] = {"mean": qu.mean(0).tolist(),
                                            "var": qu.var(0).tolist(),
                                            "step": ru.step_size.tolist()}
    # -- chain-sharded ESS ------------------------------------------------------
    _reset()
    qs, lls = run_ess(lambda q: -0.5 * torch.sum((q - 1.0) ** 2),
                      lambda gen: torch.randn(4, generator=gen, dtype=F64),
                      torch.zeros(8, 4, dtype=F64), 3, num_samples=8, num_burnin=8,
                      num_chains=8, mesh=mesh)
    out["ess"] = {"counts": _counts(), "shape": list(qs.shape),
                  "finite": bool(torch.isfinite(lls).all()), "std": float(qs.std())}
    # -- particle-sharded SMC -----------------------------------------------------
    yv = torch.tensor([0.5, -0.3], dtype=F64)

    def logprior(q):
        return -0.5 * torch.sum(q * q)

    def loglik(q):
        return -0.5 * torch.sum(torch.square(q - yv)) / 0.5

    p0 = torch.as_tensor(inp["particles"])
    _reset()
    rs = run_smc(logprior, loglik, p0, 4, mesh=mesh)
    c = _counts()
    qa = collectives.all_gather(rs.particles, group)
    ref = run_smc(logprior, loglik, p0, 4)
    out["smc"] = {"mean": qa.mean(0).tolist(), "var": qa.var(0, unbiased=False).tolist(),
                  "stages": rs.num_stages, "counts": c,
                  "max_diff_unsharded": float((qa - ref.particles).abs().max()),
                  "log_z": [float(rs.log_evidence), float(ref.log_evidence)],
                  "accept": [float(rs.acceptance), float(ref.acceptance)]}
    per_stage = {}
    for n_p in (64, 256):
        _reset()
        r = run_smc(lambda q: -0.5 * torch.sum(q * q),
                    lambda q: -0.5 * torch.sum((q - 0.5) ** 2) * 4.0,
                    torch.as_tensor(inp["particles"][:n_p]), 1, num_moves=2, mesh=mesh)
        cnt = _counts()
        per_stage[n_p] = {"stages": r.num_stages, "counts": cnt}
    out["smc"]["per_stage"] = per_stage
    return out


# ---------------------------------------------------------------------------
# the 4-rank tensor-parallel world: tests/test_sharded_linalg.py's cases
# ---------------------------------------------------------------------------


def _tp_theta(c):
    """σ², ℓ, the constant mean and the noise of the gradient cases, as
    caller tensors that require grad."""
    return [torch.tensor(v, dtype=F64, requires_grad=True) for v in c]


def _tp_fx(theta, x):
    s2, ell, c, noise = theta
    return agt.GP(c, s2 * agt.with_lengthscale(agt.Matern52Kernel(), ell))(x, noise)


def tp4(rank, world, d):
    inp = {k: torch.as_tensor(v) for k, v in np.load(os.path.join(d, "inputs.npz")).items()}
    mesh = make_mesh(world, ("tp",))
    group = mesh.get_group("tp")
    arr, out = {}, {}
    with torch.no_grad():
        arr["chol"] = sl.distributed_cholesky(inp["chol_A"], mesh, block=64)
        arr["chol_pad"] = sl.distributed_cholesky(inp["chol_pad_A"], mesh, block=64)
        arr["chol_nan"] = sl.distributed_cholesky(inp["chol_nan_A"], mesh, block=16)
        arr["gram"] = sl.sharded_gram(agt.Matern52Kernel(), inp["gram_x"], mesh)
        for n in (512, 300):
            f = agt.GP(0.3, 1.5 * agt.with_lengthscale(agt.SqExponentialKernel(), 0.7))
            arr[f"lp{n}"] = sl.sharded_logpdf(f(inp[f"lp{n}_x"], 0.1), inp[f"lp{n}_y"] + 0.3,
                                              mesh, block=64)
        fx = agt.GP(agt.Matern32Kernel())(inp["lp_diag_x"], inp["lp_diag_sig"])
        arr["lp_diag"] = sl.sharded_logpdf(fx, inp["lp_diag_y"], mesh, block=64)
        fx = agt.GP(0.1, agt.Matern52Kernel())(inp["lp_mat_x"], 0.2)
        arr["lp_mat"] = sl.sharded_logpdf(fx, inp["lp_mat_Y"], mesh, block=64)
        fx = agt.GP(agt.Matern32Kernel())(inp["rej_x"], inp["rej_S"])
        fx_iso = agt.GP(agt.Matern32Kernel())(inp["rej_x"], 0.1)
        out["raises"] = [
            _raises(lambda: sl.sharded_logpdf(fx, inp["rej_y"], mesh, block=64),
                    NotImplementedError),
            _raises(lambda: sl.sharded_logpdf(fx_iso, torch.zeros(65, dtype=F64), mesh,
                                              block=64)),
            _raises(lambda: sl.sharded_mean_and_var(fx, torch.zeros(64, dtype=F64),
                                                    inp["rej_x"][:4], mesh),
                    NotImplementedError)]
        # 32 panels at block 16, and the collectives of its sweep
        fx = agt.GP(agt.SqExponentialKernel())(inp["lp16_x"], 0.1)
        _reset()
        arr["lp16"] = sl.sharded_logpdf(fx, inp["lp16_y"], mesh, block=16)
        out["lp16_counts"] = _counts()
        out["lp16_bytes"] = dict(collectives.COLLECTIVE_BYTES)
        fx = agt.GP(0.4, agt.Matern52Kernel())(inp["pred_x"], 0.1)
        _reset()
        arr["pred_mean"], arr["pred_var"] = sl.sharded_mean_and_var(
            fx, inp["pred_y"], inp["pred_xt"], mesh, block=8)
        out["pred_counts"] = _counts()
        fx = agt.GP(0.4, agt.Matern52Kernel())(inp["pred_mat_x"], 0.1)
        arr["pred_mat_mean"], arr["pred_mat_var"] = sl.sharded_mean_and_var(
            fx, inp["pred_mat_Y"], inp["pred_mat_xt"], mesh, block=8, test_chunk=1024)
    # the gradients in (σ², ℓ, c, noise, x, y) of the logpdf, and with x* of
    # Σmean + Σvar, every rank seeding its own copy
    theta = _tp_theta((1.3, 0.7, 0.2, 0.1))
    xg, yg = inp["grad_x"].clone().requires_grad_(), inp["grad_y"].clone().requires_grad_()
    _reset()
    lp = sl.sharded_logpdf(_tp_fx(theta, xg), yg, mesh, block=16)
    out["grad_fwd_counts"] = _counts()
    _reset()
    grads = torch.autograd.grad(lp, [*theta, xg, yg])
    out["grad_bwd_counts"] = _counts()
    arr["grad_value"] = lp.detach()
    for k, g in zip(("s2", "ell", "c", "noise", "x", "y"), grads):
        arr[f"grad_{k}"] = g
    theta = _tp_theta((1.3, 0.7, 0.2, 0.1))
    xg, yg = inp["gp_x"].clone().requires_grad_(), inp["gp_y"].clone().requires_grad_()
    xt = inp["gp_xt"].clone().requires_grad_()
    m, v = sl.sharded_mean_and_var(_tp_fx(theta, xg), yg, xt, mesh, block=8)
    grads = torch.autograd.grad(m.sum() + v.sum(), [*theta, xg, yg, xt])
    for k, g in zip(("s2", "ell", "c", "noise", "x", "y", "xt"), grads):
        arr[f"gp_{k}"] = g
    # the collectives themselves: broadcast from a chosen source, and the
    # differentiable all_gather and broadcast_from
    t = torch.full((3,), float(rank), dtype=F64)
    out["broadcast_src2"] = collectives.broadcast(t, group, src=2).tolist()
    a = torch.full((2, 2), float(rank + 1), dtype=F64, requires_grad=True)
    w = torch.arange(float(2 * world * 2), dtype=F64).reshape(2 * world, 2) * (rank + 1)
    (ga,) = torch.autograd.grad((collectives.all_gather(a, group) * w).sum(), a)
    out["all_gather_grad"] = ga.tolist()
    b = torch.full((2,), float(rank + 1), dtype=F64, requires_grad=True)
    got = collectives.broadcast_from(b, 3, group)
    (gb,) = torch.autograd.grad((got * (rank + 1)).sum(), b, allow_unused=True)
    out["broadcast_from"] = [got.tolist(), None if gb is None else gb.tolist()]
    out["arrays"] = {k: v.detach().numpy() for k, v in arr.items()}
    return out


# ---------------------------------------------------------------------------
# the 2-rank world: tests/multihost_worker.py's workloads
# ---------------------------------------------------------------------------


def world2(rank, world, d):
    out = {}
    rng = np.random.default_rng(0)
    n = 64
    x = torch.as_tensor(rng.uniform(size=(n, 1)))
    y = torch.as_tensor(np.sin(3 * x.numpy()[:, 0]) + 0.1 * rng.normal(size=n))
    mesh_dp = make_pod_mesh(("dp",))

    def loss(theta, data):
        xx, yy = data
        pred = theta["w"] * xx[:, 0] + theta["b"]
        sq, cnt = psum(
            torch.sum(torch.square(pred - yy)), torch.tensor(float(yy.shape[0]), dtype=F64))
        return sq / cnt

    res = fit_sharded(loss, {"w": torch.tensor(0.0, dtype=F64), "b": torch.tensor(0.0, dtype=F64)},
                      (x, y), mesh_dp, num_steps=200,
                      optimizer=lambda ps: torch.optim.Adam(ps, lr=0.1))
    out["fit_w"] = float(res.params["w"])
    out["fit_loss"] = float(res.history[-1])

    def logdens(q):
        return -0.5 * torch.sum(q * q / torch.tensor([1.0, 4.0, 0.25], dtype=F64))

    init = init_chain_positions(7, torch.zeros(3, dtype=F64), num_chains=8)
    mcmc = run_mcmc(logdens, init, 7, num_chains=8, num_samples=100, num_warmup=100,
                    mesh=mesh_dp, mesh_axis="dp")
    draws = collectives.all_gather(mcmc.positions, mesh_dp.get_group("dp"))
    out["nuts_mean"] = [round(float(v), 10) for v in draws.mean((0, 1))]
    out["nuts_var"] = [round(float(v), 10) for v in draws.var((0, 1), unbiased=False)]
    out["world"] = [is_distributed(), num_processes()]
    # tp-sharded exact logpdf across processes
    mesh_tp = make_pod_mesh(("tp",))
    fx = agt.GP(agt.Matern52Kernel())(x, 0.1)
    out["sharded_logpdf"] = float(sl.sharded_logpdf(fx, y, mesh_tp, block=8))
    out["dense_logpdf"] = float(fx.logpdf(y))
    return out


def main():
    which = sys.argv[1]
    distance.set_default_device("cpu")
    torch.set_num_threads(1)
    _count_raw_collectives()
    if which in ("world4", "tp4"):
        rank, world, d = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
        initialize_distributed(f"file://{os.path.join(d, f'store_{which}')}", world, rank,
                               timeout=TIMEOUT)
        out = (world4 if which == "world4" else tp4)(rank, world, d)
        if "arrays" in out:
            np.savez(os.path.join(d, f"{which}_rank{rank}.npz"), **out.pop("arrays"))
    else:
        d = sys.argv[2]
        initialize_distributed(timeout=TIMEOUT)  # from RANK, WORLD_SIZE, MASTER_*
        rank, world = dist.get_rank(), dist.get_world_size()
        out = world2(rank, world, d)
    with open(os.path.join(d, f"{which}_rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
