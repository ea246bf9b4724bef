#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — ``GP(σ²·with_lengthscale(Matern32Kernel(),
ℓ))(x, 0.1).logpdf(y)``, then ``posterior(fx, y).mean_and_var(x*)`` — at the
full width of the exact-GP benchmark configuration (N = 8192, D = 8,
M = 4096, f32) and at a ragged width (N = 4500: a 512-wide tail slab and a
36-block row-panel trtri), checks both against an f64 ``torch.linalg``
oracle on the card, holds each hand-written kernel against its plain torch
version at the shapes the main path gives it, times the kernels with CUDA
events and the end-to-end path on the host clock (each call ends in a
device-to-host read), and traces one logpdf and one prediction with
``torch.profiler`` for the device time by kernel and the device's busy share.

Usage (from the root of a checkout): ``python3 chip_smoke.py [--seed S]``.
It builds the kernels from ``abstractgps_tpu_torch/csrc`` first. It exits
non-zero, printing no result, when no CUDA device is present or the port
cannot be imported. The last line of its output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

EPS32 = 2.0 ** -24  # f32 unit roundoff

# published peaks of one H100 SXM: HBM bytes/s and FP32 (non-tensor) flop/s
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12

# the TPU kernel each CUDA kernel replaces (file:line of the function that
# reaches pl.pallas_call)
KERNELS = {
    "gram_tile": ("abstractgps_tpu_torch/csrc/gram_tile.cu",
                  "abstractgps_tpu/ops/pallas_gram.py:128"),
    "slab_factor": ("abstractgps_tpu_torch/csrc/slab_factor.cu",
                    "abstractgps_tpu/ops/pallas_chol.py:339"),
    "chol_inv_block": ("abstractgps_tpu_torch/csrc/chol_inv_block.cu",
                       "abstractgps_tpu/ops/pallas_chol.py:179"),
    "tri_inv_block": ("abstractgps_tpu_torch/csrc/tri_inv_block.cu",
                      "abstractgps_tpu/ops/pallas_chol.py:405"),
}


def reset_launches():
    from abstractgps_tpu_torch.ops import cuda

    cuda.reset_launches()


def read_launches() -> dict:
    from abstractgps_tpu_torch.ops import cuda

    return dict(cuda.LAUNCHES)


def make_problem(seed: int, n: int, m: int, d: int, device, dtype):
    """Inputs and hyperparameters of one run, drawn from ``seed`` (as in the
    benchmark: x, x* ~ U(0,1)^D, y ~ N(0,1), σ² ~ U(0.7,1.3), ℓ ~ U(0.8,1.2))."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(size=(n, d)), dtype=dtype, device=device)
    y = torch.as_tensor(rng.normal(size=n), dtype=dtype, device=device)
    xs = torch.as_tensor(rng.uniform(size=(m, d)), dtype=dtype, device=device)
    s2, ell = float(rng.uniform(0.7, 1.3)), float(rng.uniform(0.8, 1.2))
    return x, y, xs, s2, ell


def make_kernel(s2: float, ell: float, device, dtype):
    import abstractgps_tpu_torch as agt

    k = s2 * agt.with_lengthscale(agt.Matern32Kernel(), ell)
    return k.to(device=device, dtype=dtype)


NOISE = 0.1


def run_path(kernel, x, y, xs):
    """The main path, through the entry points a user calls. Returns its
    results and the kernel launches of its logpdf and of its prediction
    (``posterior`` + ``mean_and_var``), each counted from 0."""
    import abstractgps_tpu_torch as agt

    reset_launches()
    fx = agt.GP(kernel)(x, NOISE)
    lp = fx.logpdf(y)
    counts = {"logpdf": read_launches()}
    reset_launches()
    post = agt.posterior(fx, y)
    mu, var = post.mean_and_var(xs)
    counts["pred"] = read_launches()
    return (lp.detach(), mu.detach(), var.detach(), post), counts


def total_launches(counts: dict) -> dict:
    return {k: sum(c[k] for c in counts.values()) for k in KERNELS}


def oracle_f64(s2, ell, x, y, xs):
    """Dense f64 reference on the card: torch.linalg on the full gram."""
    import torch

    import abstractgps_tpu_torch as agt

    k = make_kernel(s2, ell, x.device, torch.float64)
    x64, y64, xs64 = x.double(), y.double(), xs.double()
    n = x64.shape[0]
    K = agt.kernelmatrix(k, x64).detach() + NOISE * torch.eye(n, dtype=torch.float64,
                                                              device=x.device)
    L = torch.linalg.cholesky(K)
    z = torch.linalg.solve_triangular(L, y64[:, None], upper=False)
    lp = -0.5 * (n * math.log(2 * math.pi) + 2 * torch.log(torch.diagonal(L)).sum()
                 + (z * z).sum())
    alpha = torch.cholesky_solve(y64[:, None], L)[:, 0]
    Ks = agt.kernelmatrix(k, x64, xs64).detach()
    mu = Ks.T @ alpha
    V = torch.linalg.solve_triangular(L, Ks, upper=False)
    var = torch.clamp(s2 - (V * V).sum(0), min=0.0)
    # κ(K) ≤ λ_max / σ²_noise (λ_min ≥ the noise); λ_max by power iteration
    v = torch.ones(n, dtype=torch.float64, device=x.device)
    for _ in range(50):
        v = K @ v
        v = v / v.norm()
    kappa = float(v @ (K @ v)) * 1.01 / NOISE
    return float(lp), mu, var, kappa


def check_against_oracle(tag, lp, mu, var, ref):
    """f32 path vs f64 oracle. Tolerance: first-order rounding of an f32
    factorization and solve moves each result by ≲ κ(K)·eps relative; we
    allow 10·κ·eps, relative to |logpdf|, max|mean| and max posterior
    variance."""
    import torch

    lp64, mu64, var64, kappa = ref
    tol = 10.0 * kappa * EPS32
    errs = {
        "logpdf": abs(float(lp) - lp64) / abs(lp64),
        "mean": float((mu.double() - mu64).abs().max() / mu64.abs().max()),
        "var": float((var.double() - var64).abs().max() / var64.max()),
    }
    finite = bool(torch.isfinite(lp)) and bool(torch.isfinite(mu).all()) and bool(
        torch.isfinite(var).all())
    ok = finite and all(e <= tol for e in errs.values()) and float(var.min()) >= 0.0
    print(f"[{tag}] logpdf {float(lp):.6f} (f64 {lp64:.6f}); kappa<= {kappa:.3e}; "
          f"rel errors {json.dumps(errs)}; tol {tol:.3e}; finite {finite}; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _tol_rel(kappa: float) -> float:
    """Tolerance between two f32 evaluations of a factor or inverse of a
    matrix of condition κ, relative to max|ref|: each carries ≲ κ·eps of
    rounding; allow 10·κ·eps."""
    return 10.0 * kappa * EPS32


def kernel_checks(kernel, x, xs, L_full, slab_in, block_in):
    """Each kernel against its plain version on the card, on inputs the main
    path gave it (``slab_in``/``block_in`` were captured from the full-width
    and ragged runs, ``L_full`` is the full-width factor); then its time,
    the plain version's, a library call's, and the bound."""
    import torch

    from abstractgps_tpu_torch.ops import blocked_chol, fused_gram

    s2 = float(kernel.variance)
    base, transform = kernel.kernel.kernel, kernel.kernel.transform
    xt, xst = transform(x), transform(xs)
    fam, params = base.FAMILY, base._map_params()
    n, d = xt.shape
    m = xst.shape[0]
    pbuf = fused_gram._params_buffer(params, x.device)
    B = blocked_chol._BLOCK
    norm2 = lambda A: float(torch.linalg.matrix_norm(A.double(), 2))  # noqa: E731
    recs = {}

    def record(name, err, tol, ms, plain_ms, lib_ms, nbytes, flops, shape):
        b, by = bound_ms(nbytes, flops)
        ok = err <= tol
        print(f"[kernel {name}] shape {shape}: max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"bound {b:.4f} ms ({by})", flush=True)
        recs[name] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=b, bound_by=by, ok=ok,
                          shape=shape)

    # gram_tile at the prediction cross-gram (n, m) (σ² is applied outside
    # it). Tolerance: d² rounding ≲ 8·eps·(‖x‖² + ‖z‖²) ≤ 1.2e-5 at D = 8,
    # ℓ ≥ 0.8, and |dg/d(d²)| ≤ 1.5 for Matérn-3/2 → |ΔK| ≤ 2e-5: 3e-5 stated
    got = fused_gram.gram_tile(xt, xst, fam, params)
    want = fused_gram.gram_tile_plain(xt, xst, fam, pbuf)
    err = float((got - want).abs().max())
    ms = cuda_ms(lambda: fused_gram.gram_tile(xt, xst, fam, params), 20)
    plain = cuda_ms(lambda: fused_gram.gram_tile_plain(xt, xst, fam, pbuf), 5)
    record("gram_tile", err, 3e-5, ms, plain, None,
           4.0 * (n * d + m * d + n * m), n * m * (3.0 * d + 12.0), [n, m, d])

    # slab_factor on the first slab of the full-width sweep; κ(S) ≤ ‖S‖/σ²
    # (the noise bounds λ_min from below)
    S = slab_in
    W = S.shape[0]
    Lk, Wk = blocked_chol.slab_factor(S, B)
    Lp, Wp = blocked_chol.slab_factor_plain(S, B)
    err = max(float((Lk - Lp).abs().max()), float((Wk - Wp).abs().max()))
    scale = max(float(Lp.abs().max()), float(Wp.abs().max()))
    ms = cuda_ms(lambda: blocked_chol.slab_factor(S, B), 10)
    plain = cuda_ms(lambda: blocked_chol.slab_factor_plain(S, B), 2)

    def lib_slab():
        Lc = torch.linalg.cholesky(S)
        blocks = torch.stack([Lc[i:i + B, i:i + B] for i in range(0, W, B)])
        eye = torch.eye(B, device=S.device).expand(blocks.shape)
        return torch.linalg.solve_triangular(blocks, eye, upper=False)

    lib = cuda_ms(lib_slab, 10)
    record("slab_factor", err, _tol_rel(norm2(S) / NOISE) * scale, ms, plain, lib,
           4.0 * (2 * W * W + W * B), W ** 3 / 3.0 + (W // B) * B ** 3 / 3.0, [W, B])

    # chol_inv_block on the first block of the ragged run's 512-wide tail
    # slab (a Schur complement of K + σ²I: κ ≤ ‖A‖/σ² again)
    A = block_in
    Lk, Wk = blocked_chol.chol_inv_block(A)
    Lp, Wp = blocked_chol.chol_inv_block_plain(A)
    err = max(float((Lk - Lp).abs().max()), float((Wk - Wp).abs().max()))
    scale = max(float(Lp.abs().max()), float(Wp.abs().max()))
    ms = cuda_ms(lambda: blocked_chol.chol_inv_block(A), 50)
    plain = cuda_ms(lambda: blocked_chol.chol_inv_block_plain(A), 3)
    eyeB = torch.eye(B, device=A.device)
    lib = cuda_ms(lambda: torch.linalg.solve_triangular(torch.linalg.cholesky(A), eyeB,
                                                        upper=False), 50)
    record("chol_inv_block", err, _tol_rel(norm2(A) / NOISE) * scale, ms, plain, lib,
           4.0 * 3 * B * B, 2.0 * B ** 3 / 3.0, [B, B])

    # tri_inv_block over the diagonal blocks of the full-width factor, as the
    # prediction solve's doubling trtri calls it; κ(L_ii) ≤ sqrt(‖K‖/σ²)
    L = L_full
    nb = L.shape[0] // B
    got = blocked_chol.tri_inv_block(L, B)
    want = blocked_chol.tri_inv_block_plain(L, B)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    kappa_l = math.sqrt(s2 * n / NOISE)  # ‖K‖ ≤ n·max k = n·σ²
    ms = cuda_ms(lambda: blocked_chol.tri_inv_block(L, B), 20)
    plain = cuda_ms(lambda: blocked_chol.tri_inv_block_plain(L, B), 2)
    blocks = torch.stack([L[i * B:(i + 1) * B, i * B:(i + 1) * B] for i in range(nb)])
    eyes = torch.eye(B, device=L.device).expand(blocks.shape)
    lib = cuda_ms(lambda: torch.linalg.solve_triangular(blocks, eyes, upper=False), 20)
    record("tri_inv_block", err, _tol_rel(kappa_l) * scale, ms, plain, lib,
           4.0 * 2 * nb * B * B, nb * B ** 3 / 3.0, [nb, B, B])
    return recs


class capture_first_input:
    """Record a clone of the first argument of the first call of a
    blocked_chol kernel wrapper during a run (the wrapper still runs and
    counts its launch)."""

    def __init__(self, name):
        from abstractgps_tpu_torch.ops import blocked_chol

        self.mod, self.name = blocked_chol, name
        self.orig = getattr(blocked_chol, name)
        self.value = None

    def __enter__(self):
        def spy(A, *rest):
            if self.value is None:
                self.value = A.detach().clone()
            return self.orig(A, *rest)

        setattr(self.mod, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def profile_breakdown(name: str, fn, top: int = 10) -> None:
    """One warm call of ``fn`` under ``torch.profiler``: device time by
    kernel name, and the device's busy share of the traced window (the
    union of kernel intervals over the span from the first traced host op
    to the last kernel's end; the profiler's own overhead widens it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    wall_us = (max(e.time_range.end for e in events)
               - min(e.time_range.start for e in events))
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy, end = 0.0, -math.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    device_us = sum(t for t, _ in by_name.values())
    print(f"[profile {name}] window {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({busy / wall_us:.3f} of the window), {len(kernels)} kernel launches",
          flush=True)
    for kname, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[profile {name}]   {t / 1e3:9.3f} ms {t / device_us:6.3f} x{n:<5d} "
              f"{kname[:90]}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import abstractgps_tpu_torch as agt
        from abstractgps_tpu_torch.ops import cuda
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    agt.set_default_device(dev)
    print(gpu_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    cuda.library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    ok = True
    f32 = torch.float32

    # ---- the main path: full width, then the ragged width -----------------
    N, M, D, N_RAGGED, M_RAGGED = 8192, 4096, 8, 4500, 1024
    x, y, xs, s2, ell = make_problem(args.seed, N, M, D, dev, f32)
    kernel = make_kernel(s2, ell, dev, f32)
    xr, yr, xsr, s2r, ellr = make_problem(args.seed + 1, N_RAGGED, M_RAGGED, D, dev, f32)
    kernel_r = make_kernel(s2r, ellr, dev, f32)

    with capture_first_input("slab_factor") as slab_in:
        (lp, mu, var, post), full_counts = run_path(kernel, x, y, xs)
    torch.cuda.synchronize()
    with capture_first_input("chol_inv_block") as block_in:
        (lp_r, mu_r, var_r, _), ragged_counts = run_path(kernel_r, xr, yr, xsr)
    torch.cuda.synchronize()
    full, ragged = total_launches(full_counts), total_launches(ragged_counts)
    launches = {k: full[k] + ragged[k] for k in full}
    print(f"[launches] full width {json.dumps(full_counts)}; "
          f"ragged {json.dumps(ragged_counts)}", flush=True)
    need_full = ("gram_tile", "slab_factor", "tri_inv_block")
    if not all(full[k] > 0 for k in need_full) or not all(v > 0 for v in ragged.values()):
        print("[launches] FAIL: a kernel of the path was not launched", flush=True)
        ok = False

    with torch.no_grad():
        ok_f = check_against_oracle(f"full N={N} M={M}", lp, mu, var,
                                    oracle_f64(s2, ell, x, y, xs))
        ok_r = check_against_oracle(f"ragged N={N_RAGGED} M={M_RAGGED}", lp_r, mu_r,
                                    var_r, oracle_f64(s2r, ellr, xr, yr, xsr))
    shapes_ok = mu.shape == (M,) and var.shape == (M,) and mu_r.shape == (M_RAGGED,)
    ok = ok and ok_f and ok_r and shapes_ok

    # ---- each kernel against its plain version; times ---------------------
    with torch.no_grad():
        recs = kernel_checks(kernel, x, xs, post.data.L.detach(), slab_in.value,
                             block_in.value)
    ok = ok and all(r["ok"] for r in recs.values())

    # ---- end to end ----------------------------------------------------------
    def logpdf_once():
        return float(agt.GP(kernel)(x, NOISE).logpdf(y).detach())

    def pred_once():
        p = agt.posterior(agt.GP(kernel)(x, NOISE), y)
        m_, v_ = p.mean_and_var(xs)
        return float((m_.sum() + v_.sum()).detach())

    logpdf_once()
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        logpdf_once()
    logpdf_s = (time.perf_counter() - t0) / reps
    pred_once()
    t0 = time.perf_counter()
    for _ in range(3):
        pred_once()
    pred_s = (time.perf_counter() - t0) / 3
    print(f"[e2e] N={N} D={D} M={M} f32: logpdf {logpdf_s * 1e3:.3f} ms "
          f"({1.0 / logpdf_s:.3f} evals/s); pred {pred_s * 1e3:.3f} ms "
          f"({1.0 / pred_s:.3f} evals/s); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_breakdown("logpdf", logpdf_once)
    profile_breakdown("pred", pred_once)

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
