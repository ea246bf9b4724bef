#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths — serving: ``GP(σ²·with_lengthscale(
Matern32Kernel(), ℓ))(x, 0.1).logpdf(y)``, then ``posterior(fx, y)
.mean_and_var(x*)``; training: ``torch.autograd.grad`` of the logpdf and of
the prediction with respect to σ², ℓ and the noise (caller tensors), and
five Adam steps of ``fit(nlml(...))`` — at the full width of the exact-GP
benchmark configuration (N = 8192, D = 8, M = 4096, f32) and at a ragged
width (N = 4500: a 512-wide tail slab and a 36-block row-panel trtri);
then a deep kernel, σ²·Matérn-3/2 ∘ ``FunctionTransform`` of an MLP whose
weights are a list of ``{"w", "b"}`` dicts: ∇logpdf at N = 8192 with
respect to every MLP tensor, and two ``fit`` steps. Before those, the
samplers: hyperparameter NUTS over the exact-GP logpdf (q = log(σ², ℓ,
noise), N = 2048, D = 8, f32, 2 chains, ``chain_eval="loop"``; every
leapfrog is one fused ∇logpdf), its ∇logpdf against f64, a non-PD gram
that must be a rejection, its kernels against their plain versions and
its peak memory; the same ∇logpdf with ``set_enabled(False)``, which
must launch no kernel; latent-Poisson NUTS (256 latents, 64 chains,
``chain_eval="vmap"``) with R-hat and bulk ESS; elliptical slice sampling
of a LatentGP Poisson model; SMC on a conjugate Gaussian. Then the sparse
slice at BASELINE.json config 3 (n = 50 000, D = 8, M = 512, B = 2048,
σ²·SE∘ARD, the data of ``examples/sparse_vfe_50k.py`` drawn on the card):
20 joint Adam steps of the SVGP ELBO from a constrained tree and 5
natural-gradient steps, one ∇ at M = 1024 against f64 (``[svgp]``); the
collapsed VFE bound and its gradient on all 50 000 points against f64,
DTC, the VFE posterior and both ``update_posterior`` paths against the
batch posterior (``[sparse]``); 16 streaming extends of 512 into a cache
of capacity 8192 against the exact posterior, and one past the capacity,
which must give NaN (``[online]``); each with its launches per step or
extend and its kernels against their plain versions on its own inputs.
Then the matrix-free CG backend at N = 32 768 (D = 8, σ²·Matérn-3/2,
σ² = ℓ = 1, noise 0.1, ``CGInference()``'s defaults: one fused matvec,
``gram_matvec``, a solver step; the backward's 32 panels of 1024 rows):
``approx_log_evidence``, its gradient in (σ², ℓ, noise),
the posterior, ``mean`` at 4096 points and ``mean_and_var`` at 256, each
with its launches, host times and the steps its CG columns stayed active,
against a dense f64 oracle (true residuals, the SLQ logdet in standard
errors of its probes, the ∇ in its spread over four probe seeds, the
posterior within CG's A-norm bound), again with the fused gram switched
off (``[cg]``), the fused matvec against its plain version and timed at
N = 32 768, q = 33; and 1024 pathwise samples of the full-width exact
posterior at 4096 points, their moments against the f64 posterior
(``[pathwise]``).
Checks values and gradients against f64 ``torch.linalg`` oracles on the
card, holds each hand-written kernel against its plain torch version at
the shapes the main path gives it (the backward kernels also bit for bit
against a second call, kernel 5 also with NaN above T's diagonal;
``chol_block``, which no path runs, on blocks the
main path produced, its launches counted in its own phase and its line
marked ``"path": null``), times the kernels with CUDA events (the block
and backward kernels and the gram tile, at the prediction's shape and at
one sweep panel, also in device time under ``torch.profiler``) and
the end-to-end paths on the host clock (each call ends in a device-to-host
read; the full width's four, the ragged width's prediction and
gradient), and traces one logpdf, one prediction and the gradient of each
with ``torch.profiler`` for the device time by kernel and the device's
busy share.

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
import os
import subprocess
import sys
import time

EPS32 = 2.0 ** -24  # f32 unit roundoff

# the published HBM rate of one H100 SXM, bytes/s (its FP32 non-tensor peak,
# 67e12 flop/s, is ``utils.profiling.H100_PEAK_F32``)
H100_BYTES_PER_S = 3.35e12

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
    "logpdf_contraction": ("abstractgps_tpu_torch/csrc/logpdf_contraction.cu",
                           "abstractgps_tpu/ops/pallas_gram.py:359"),
    "gram_bwd": ("abstractgps_tpu_torch/csrc/gram_bwd.cu",
                 "abstractgps_tpu/ops/pallas_gram.py:185"),
    "chol_block": ("abstractgps_tpu_torch/csrc/chol_block.cu",
                   "abstractgps_tpu/ops/pallas_chol.py:455"),
    "gram_matvec": ("abstractgps_tpu_torch/csrc/gram_matvec.cu",
                    "none (abstractgps_tpu/ops/matvec.py's lax.fori_loop over gram panels)"),
}
# kernels that no path of the port runs: their launches are those of their
# own phase in ``kernel_checks``
OFF_PATH = ("chol_block",)
SIGMA2_BUDGET = 5e-3  # the JAX package's σ²-gradient budget against f64


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


def caller_theta(s2: float, ell: float, device, dtype):
    """σ², ℓ and the noise as the caller's own tensors that require grad."""
    import torch

    return [torch.tensor(v, dtype=dtype, device=device, requires_grad=True)
            for v in (s2, ell, NOISE)]


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


def run_grad_path(theta, x, y, xs=None):
    """The training path: ``torch.autograd.grad`` of the logpdf (``xs`` is
    None) or of ``mean.sum() + var.sum()`` of the prediction at ``xs`` with
    respect to ``theta`` = (σ², ℓ, noise). Returns the gradient (f64 on
    the host) and the kernel launches of the run, counted from 0."""
    import torch

    import abstractgps_tpu_torch as agt

    s2, ell, noise = theta
    reset_launches()
    fx = agt.GP(s2 * agt.with_lengthscale(agt.Matern32Kernel(), ell))(x, noise)
    if xs is None:
        out = fx.logpdf(y)
    else:
        mu, var = agt.posterior(fx, y).mean_and_var(xs)
        out = mu.sum() + var.sum()
    grads = torch.autograd.grad(out, theta)
    torch.cuda.synchronize()
    return torch.stack(grads).double().cpu(), read_launches()


def total_launches(counts: dict) -> dict:
    return {k: sum(c[k] for c in counts.values()) for k in KERNELS if k not in OFF_PATH}


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


def _matern32_f64(r2, s2, ell):
    """σ²·Matérn-3/2 from squared distances r2 of the unscaled inputs."""
    import torch

    t = math.sqrt(3.0) * torch.sqrt(r2) / ell
    return s2 * (1.0 + t) * torch.exp(-t)


def grad_oracle_f64(s2, ell, x, y, xs=None, noise=NOISE):
    """Dense f64 reference on the card, written apart from the port: the
    Matérn-3/2 gram from f64 distances, ``torch.linalg.cholesky``, and
    autograd of the logpdf (or of ``mean.sum() + var.sum()`` at ``xs``)
    with respect to (σ², ℓ, noise)."""
    import torch

    dev = x.device
    th = [torch.tensor(v, dtype=torch.float64, device=dev, requires_grad=True)
          for v in (s2, ell, noise)]
    x64, y64 = x.double(), y.double()
    n = x64.shape[0]
    with torch.no_grad():
        r2 = torch.cdist(x64, x64).square_()
        r2.fill_diagonal_(0.0)
    K = _matern32_f64(r2, th[0], th[1]) + th[2] * torch.eye(n, dtype=torch.float64,
                                                            device=dev)
    L = torch.linalg.cholesky(K)
    if xs is None:
        z = torch.linalg.solve_triangular(L, y64[:, None], upper=False)
        out = -0.5 * (n * math.log(2 * math.pi) + 2 * torch.log(torch.diagonal(L)).sum()
                      + (z * z).sum())
    else:
        with torch.no_grad():
            r2s = torch.cdist(x64, xs.double()).square_()
        Ks = _matern32_f64(r2s, th[0], th[1])
        alpha = torch.cholesky_solve(y64[:, None], L)[:, 0]
        V = torch.linalg.solve_triangular(L, Ks, upper=False)
        out = (Ks.T @ alpha).sum() + torch.clamp(th[0] - (V * V).sum(0), min=0.0).sum()
    grads = torch.autograd.grad(out, th)
    return torch.stack(grads).detach().cpu()


def check_grads(tag, got, want, kappa, budget=True):
    """f32 gradient vs the f64 oracle, component by component (σ², ℓ,
    noise). Tolerance: each component is a contraction of ½(ααᵀ − K⁻¹)
    (chained through the prediction's solves) whose f32 rounding is ≲ κ·eps
    relative, as for the forward; we allow 10·κ·eps. For ∇logpdf the σ²
    component is also set beside the JAX package's 5e-3 budget (which the
    JAX package pins for ∇logpdf only)."""
    import torch

    tol = 10.0 * kappa * EPS32
    rel = ((got - want).abs() / want.abs()).tolist()
    finite = bool(torch.isfinite(got).all())
    ok = finite and max(rel) <= tol
    print(f"[{tag}] grad (s2, ell, noise) {[round(v, 6) for v in got.tolist()]} "
          f"(f64 {[round(v, 6) for v in want.tolist()]}); rel errors "
          f"{json.dumps(dict(zip(('s2', 'ell', 'noise'), rel)))}; tol {tol:.3e}; "
          + (f"s2 rel error {rel[0]:.3e} vs budget {SIGMA2_BUDGET:g} "
             f"({'within' if rel[0] <= SIGMA2_BUDGET else 'OVER'}); " if budget else "")
          + f"finite {finite}; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


# the deep kernel: σ²·(Matérn-3/2 ∘ ℓ) ∘ FunctionTransform(mlp), the MLP's
# widths from the 8 input features to 2, its tree a list of {"w", "b"} dicts
# (the layout of examples/deep_kernel_learning.py)
MLP_SIZES = (8, 16, 16, 2)


def mlp_apply(params, x):
    """The deep kernel's feature map: tanh hidden layers, a linear output."""
    import torch

    h = x
    for layer in params[:-1]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    return h @ params[-1]["w"] + params[-1]["b"]


def make_mlp(seed: int, device, dtype):
    """MLP weights drawn from ``seed`` (w scaled by √(2/fan-in), b small), as
    tensors that require grad."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def leaf(a):
        return torch.tensor(a, dtype=dtype, device=device, requires_grad=True)

    return [{"w": leaf(rng.normal(size=(a, b)) * math.sqrt(2.0 / a)),
             "b": leaf(0.1 * rng.normal(size=b))}
            for a, b in zip(MLP_SIZES[:-1], MLP_SIZES[1:])]


def mlp_leaves(mlp) -> list:
    return [t for layer in mlp for t in (layer["w"], layer["b"])]


def deep_kernel(s2, ell, mlp):
    import abstractgps_tpu_torch as agt

    return s2 * agt.compose(agt.with_lengthscale(agt.Matern32Kernel(), ell),
                            agt.FunctionTransform(mlp, mlp_apply))


def run_deep_grad(theta, mlp, x, y):
    """∇logpdf of the deep kernel with respect to (σ², ℓ, noise) and every
    MLP tensor, on the fused path. Returns the gradients (f64 on the host),
    the kernel launches of the run, counted from 0, and whether the logpdf
    required grad."""
    import torch

    import abstractgps_tpu_torch as agt

    reset_launches()
    lp = agt.GP(deep_kernel(theta[0], theta[1], mlp))(x, theta[2]).logpdf(y)
    grads = torch.autograd.grad(lp, [*theta, *mlp_leaves(mlp)]) if lp.requires_grad else []
    torch.cuda.synchronize()
    return [g.double().cpu() for g in grads], read_launches(), lp.requires_grad


def deep_grad_oracle_f64(s2, ell, mlp, x, y):
    """Dense f64 reference on the card, written apart from the port: the
    MLP's features, their f64 distances by differences, σ²·Matérn-3/2,
    ``torch.linalg.cholesky`` and autograd of the logpdf with respect to
    (σ², ℓ, noise) and every MLP tensor. Returns the gradients and κ(K)'s
    bound λ_max / noise (λ_max by power iteration)."""
    import torch

    dev = x.device
    th = [torch.tensor(v, dtype=torch.float64, device=dev, requires_grad=True)
          for v in (s2, ell, NOISE)]
    leaves = [t.detach().double().requires_grad_() for t in mlp_leaves(mlp)]
    h = mlp_apply([{"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2])],
                  x.double()) / th[1]
    n = h.shape[0]
    r2 = sum((h[:, k, None] - h[None, :, k]) ** 2 for k in range(h.shape[1]))
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    t = math.sqrt(3.0) * torch.sqrt(torch.where(eye, 1.0, r2))  # no sqrt(0) on the diagonal
    K = th[0] * torch.where(eye, 1.0, (1.0 + t) * torch.exp(-t)) + th[2] * eye.double()
    del r2, t
    L = torch.linalg.cholesky(K)
    z = torch.linalg.solve_triangular(L, y.double()[:, None], upper=False)
    out = -0.5 * (n * math.log(2 * math.pi) + 2 * torch.log(torch.diagonal(L)).sum()
                  + (z * z).sum())
    grads = [g.detach().cpu() for g in torch.autograd.grad(out, [*th, *leaves])]
    with torch.no_grad():
        Kd = K.detach()
        v = torch.ones(n, dtype=torch.float64, device=dev)
        for _ in range(50):
            v = Kd @ v
            v = v / v.norm()
        kappa = float(v @ (Kd @ v)) * 1.01 / NOISE
    return grads, kappa


def check_deep_grads(tag, got, want, kappa):
    """Each leaf's f32 gradient against f64 in norm, relative to the leaf's
    norm, at 10·κ·eps as ``check_grads`` holds the others. The output bias's
    exact gradient is 0 (the kernel is stationary: one shift of every
    feature changes no distance), so its error is taken relative to the
    output weight's gradient."""
    import torch

    tol = 10.0 * kappa * EPS32
    names = ["s2", "ell", "noise"] + [f"{p}{i}" for i in range(len(MLP_SIZES) - 1)
                                      for p in ("w", "b")]
    rel = {}
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        scale = want[i - 1] if i == len(names) - 1 else w
        rel[name] = float((g - w).norm() / scale.norm())
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    ok = finite and len(got) == len(names) and max(rel.values()) <= tol
    print(f"[{tag}] relative errors by leaf {json.dumps(rel)}; tol {tol:.3e}; finite {finite}; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


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


def device_ms(fn, iters: int = 10, windows: int = 3):
    """Device time of one call of ``fn``: the summed durations of the kernels
    it launched, under ``torch.profiler``, per call over ``iters`` calls;
    the median over ``windows`` traced windows that recorded every kernel.
    On the card a window has recorded fewer kernels than the others, or
    none (it then read below the kernel's byte bound, or 0), so a window
    counts only when it holds as many kernel records as the fullest window
    and at least one per call; up to 3·``windows`` are traced, and None is
    returned when none is full. Unlike ``cuda_ms`` it leaves out the host's
    cost of issuing the call, which bounds ``cuda_ms`` for a kernel of tens
    of µs behind a Python wrapper."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    traced = []  # (kernel records, ms per call)
    for _ in range(3 * windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        traced.append((len(spans), sum(spans) / iters / 1e3))
        most = max(n for n, _ in traced)
        full = sorted(ms for n, ms in traced if n == most and n >= iters)
        if len(full) >= windows:
            break
    if not full:
        print(f"device_ms: no traced window recorded the kernels: {traced}", flush=True)
        return None
    return full[len(full) // 2]


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def bound_ms(nbytes: float, flops: float):
    from abstractgps_tpu_torch.utils.profiling import H100_PEAK_F32

    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# operations of agp::map_vjp per family id (csrc/gram_sweep.cuh), a sqrt,
# exp, pow, log or trig counting as one and constants hoisted
MAP_VJP_FLOPS = {0: 3, 1: 4, 2: 6, 3: 11, 4: 9, 5: 9, 6: 6}


def sweep_flops(n, m, d, family, sym, cot_flops, epi_flops):
    """Operations a backward sweep over the (n, m) grid needs: per pair
    (each entry of the lower triangle when ``sym``, else each entry) d²
    from the differences (3D), the cotangent entry (``cot_flops``), the map
    VJP and the epilogue (``epi_flops``; + 2 for Σ C·∂g/∂p of a map
    hyperparameter); per ordered entry the x̄ update w·(x_r − z_c) (3D)."""
    pairs = n * (n + 1) / 2 if sym else n * m
    per_pair = 3 * d + cot_flops + MAP_VJP_FLOPS[family] + epi_flops + (
        2 if family in (4, 5) else 0)
    return pairs * per_pair + n * m * 3.0 * d


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

    def device_times(name, kernel_fn, lib_fn):
        # the kernel's and the library call's device time per call: for the
        # block kernels the host's cost of issuing a call bounds cuda_ms
        r = recs[name]
        r["device_ms"], r["library_device_ms"] = device_ms(kernel_fn), device_ms(lib_fn)
        print(f"[kernel {name}] device time per call {_ms(r['device_ms'])} ms, library "
              f"{_ms(r['library_device_ms'])} ms", flush=True)

    # gram_tile at the prediction cross-gram (n, m) (σ² is applied outside
    # it). Tolerance: d² from the differences rounds ≲ (D + 1)·eps·d² ≤
    # 6.7e-6 in the unit cube at D = 8, ℓ ≥ 0.8, and |dg/d(d²)| ≤ 1.5 for
    # Matérn-3/2 → |ΔK| ≤ 1e-5: 3e-5 stated
    got = fused_gram.gram_tile(xt, xst, fam, params)
    want = fused_gram.gram_tile_plain(xt, xst, fam, pbuf)
    err = float((got - want).abs().max())
    ms = cuda_ms(lambda: fused_gram.gram_tile(xt, xst, fam, params), 20)
    plain = cuda_ms(lambda: fused_gram.gram_tile_plain(xt, xst, fam, pbuf), 5)

    def gram_work(rows, cols):  # bytes (x, z read, K written once), operations
        return 4.0 * ((rows + cols) * d + rows * cols), rows * cols * (3.0 * d + 12.0)

    record("gram_tile", err, 3e-5, ms, plain, None, *gram_work(n, m), [n, m, d])
    del got, want
    r = recs["gram_tile"]
    r["device_ms"] = device_ms(lambda: fused_gram.gram_tile(xt, xst, fam, params))
    # one sweep panel of the logpdf: K(x[r0:], x[r0:r0 + 1024]) at r0 = 0
    w = blocked_chol._OUTER
    xw = xt[:w]
    got = fused_gram.gram_tile(xt, xw, fam, params)
    r["panel_max_abs_err"] = float((got - fused_gram.gram_tile_plain(xt, xw, fam, pbuf))
                                   .abs().max())
    r["panel_device_ms"] = device_ms(lambda: fused_gram.gram_tile(xt, xw, fam, params))
    r["panel_bound_ms"] = bound_ms(*gram_work(n, w))[0]
    r["panel_shape"] = [n, w, d]
    r["ok"] = r["ok"] and r["panel_max_abs_err"] <= 3e-5
    print(f"[kernel gram_tile] device time per call {_ms(r['device_ms'])} ms at {[n, m, d]}; "
          f"sweep panel {[n, w, d]}: max_abs_err {r['panel_max_abs_err']:.3e} (tol 3e-5), "
          f"device time per call {_ms(r['panel_device_ms'])} ms, bound "
          f"{r['panel_bound_ms']:.4f} ms", flush=True)

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
           4.0 * (W * (W + 1) / 2 + W * W + W * B),
           W ** 3 / 3.0 + (W // B) * B ** 3 / 3.0, [W, B])
    device_times("slab_factor", lambda: blocked_chol.slab_factor(S, B), lib_slab)

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

    def lib_block():
        return torch.linalg.solve_triangular(torch.linalg.cholesky(A), eyeB, upper=False)

    lib = cuda_ms(lib_block, 50)
    record("chol_inv_block", err, _tol_rel(norm2(A) / NOISE) * scale, ms, plain, lib,
           4.0 * (B * (B + 1) / 2 + 2 * B * B), 2.0 * B ** 3 / 3.0, [B, B])
    device_times("chol_inv_block", lambda: blocked_chol.chol_inv_block(A), lib_block)

    # chol_block (on no path) on two blocks the main path produced: the
    # first block of the full-width slab and the ragged run's block above;
    # its launches are this phase's own
    from abstractgps_tpu_torch.ops import cuda

    before = cuda.LAUNCHES["chol_block"]
    checks = []  # (error, tolerance) per block; a nonzero upper triangle fails
    for A in (slab_in[:B, :B], block_in):
        got = blocked_chol.chol_block(A)
        want = blocked_chol.chol_block_plain(A)
        upper_zero = bool(torch.all(torch.triu(got, 1) == 0))
        checks.append((float((got - want).abs().max()) if upper_zero else math.inf,
                       _tol_rel(norm2(A) / NOISE) * float(want.abs().max())))
    err, tol = max(checks, key=lambda c: c[0] / c[1])
    A = block_in
    ms = cuda_ms(lambda: blocked_chol.chol_block(A), 50)
    plain = cuda_ms(lambda: blocked_chol.chol_block_plain(A), 3)
    lib = cuda_ms(lambda: torch.linalg.cholesky(A), 50)
    record("chol_block", err, tol, ms, plain, lib, 4.0 * (B * (B + 1) / 2 + B * B),
           B ** 3 / 3.0, [B, B])
    device_times("chol_block", lambda: blocked_chol.chol_block(A),
                 lambda: torch.linalg.cholesky(A))
    recs["chol_block"]["launches"] = cuda.LAUNCHES["chol_block"] - before
    if recs["chol_block"]["launches"] == 0:
        recs["chol_block"]["ok"] = False

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

    def lib_blocks():
        return torch.linalg.solve_triangular(blocks, eyes, upper=False)

    lib = cuda_ms(lib_blocks, 20)
    record("tri_inv_block", err, _tol_rel(kappa_l) * scale, ms, plain, lib,
           4.0 * nb * (B * (B + 1) / 2 + B * B), nb * B ** 3 / 3.0, [nb, B, B])
    device_times("tri_inv_block", lambda: blocked_chol.tri_inv_block(L, B), lib_blocks)
    # one block read in place, alone: the launch's fixed cost
    Lii = L[:B, :B]
    r = recs["tri_inv_block"]
    r["one_block_device_ms"] = device_ms(lambda: blocked_chol.tri_inv_block(Lii, B))
    r["one_block_library_device_ms"] = device_ms(
        lambda: torch.linalg.solve_triangular(Lii, eyeB, upper=False))
    print(f"[kernel tri_inv_block] one block alone: device time per call "
          f"{_ms(r['one_block_device_ms'])} ms, library {_ms(r['one_block_library_device_ms'])} ms",
          flush=True)
    return recs


def _bwd_compare(name, got, want, xbar_mag, m, shape):
    """A backward kernel's (scalars..., x̄) against its plain version's.

    x̄ = xscale·Σ_c w_rc (x_r − z_c) sums m f32 terms per entry, in another
    order than the plain version. Rounding of two such sums differs by ~√m·eps times
    the sum of the terms' magnitudes (``xbar_mag``, entry by entry); the
    largest ratio seen on the card at m = 8192 is 0.35 of that, so we allow
    2·√m·eps·Σ|terms|. A tile of 64 terms skipped or counted twice moves an
    entry by ~8/m·Σ|terms| with random signs, ~90× this tolerance at
    m = 8192. The scalars are f64 sums of f32 products that differ by a few
    ulp: 1e-4 relative."""
    import torch

    *scalars, xb = got
    *scalars_w, xb_w = want
    errs = [float((g_.double() - w_.double()).abs()) for g_, w_ in zip(scalars, scalars_w)]
    ok = all(e <= 1e-4 * abs(float(w_)) for e, w_ in zip(errs, scalars_w))
    dx = (xb - xb_w).abs()
    tol = (2.0 * math.sqrt(m) * EPS32 * xbar_mag).clamp_min(torch.finfo(torch.float32).tiny)
    ratio = float((dx / tol).max())
    errs.append(float(dx.max()))
    ok = ok and ratio <= 1.0
    print(f"[kernel {name}] shape {shape}: abs errors {[f'{e:.3e}' for e in errs]} "
          f"(scalars: tol 1e-4 relative; x̄: largest error / tolerance {ratio:.3e}, "
          f"tol 1; max error / max|x̄| {errs[-1] / max(float(xb_w.abs().max()), 1e-300):.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return max(errs), ok


def _xbar_mag(w, x_, z_, xscale):
    from abstractgps_tpu_torch.ops.precision import full_f32

    w = w.abs()
    with full_f32():
        return xscale * (w.sum(1, keepdim=True) * x_.abs() + w @ z_.abs())


def _repeat(fn, name):
    import torch

    a, b = fn(), fn()
    same = all(torch.equal(u, v) for u, v in zip(a, b))
    print(f"[kernel {name}] two calls on the same inputs identical bit for bit: {same}",
          flush=True)
    return a, same


def _bwd_record(name, err, ok, fn, plain_ms, nbytes, flops, shape):
    # the time through the wrapper (CUDA events) and the device time
    b, by = bound_ms(nbytes, flops)
    ms, dev = cuda_ms(fn, 20), device_ms(fn)
    print(f"[kernel {name}] shape {shape}: {ms:.4f} ms, device time per call {_ms(dev)} ms, "
          f"plain {plain_ms:.4f} ms, library None ms, bound {b:.4f} ms ({by})", flush=True)
    return dict(max_abs_err=err, tol=None, ms=ms, device_ms=dev, plain_ms=plain_ms,
                library_ms=None, bound_ms=b, bound_by=by, ok=ok, shape=shape)


def backward_kernel_checks(contr_in, bwd_in=None):
    """Kernels 5 and 6 on the inputs the gradient paths gave them:
    ``contr_in`` the arguments of the first ``logpdf_contraction`` call of
    the full-width ∇logpdf, ``bwd_in`` those of the first ``gram_bwd`` call
    of each mode in the full-width ∇prediction (None: kernel 5 alone). Each
    is held against its plain version, called twice (the results must agree
    bit for bit), timed beside its bound."""
    import torch

    from abstractgps_tpu_torch.ops import fused_gram
    from abstractgps_tpu_torch.ops.precision import full_f32

    recs = {}
    # logpdf_contraction at the full-width ∇logpdf. Operations: C and g(d²)
    # are symmetric, so d², C (2q + 3) and the map VJP are needed once per
    # entry of the lower triangle, x̄′ once per ordered entry; bytes: T's
    # lower triangle, x′, α, α·ḡ read once, x̄′ written once
    xp, s2, ag, a, gsum, T, fam, params = contr_in
    n, d = xp.shape
    q = a.shape[1]
    got, same = _repeat(lambda: fused_gram.logpdf_contraction(*contr_in), "logpdf_contraction")
    # T's strict upper triangle is never read: NaN there changes no bit
    upper = torch.ones((n, n), dtype=torch.bool, device=T.device).triu_(1)
    got_nan = fused_gram.logpdf_contraction(xp, s2, ag, a, gsum, T.masked_fill(upper, math.nan),
                                            fam, params)
    del upper
    nan_ok = all(bool(torch.isfinite(t).all()) and torch.equal(t, u)
                 for t, u in zip(got_nan, got))
    print(f"[kernel logpdf_contraction] NaN above T's diagonal: finite and identical bits "
          f"{nan_ok}", flush=True)
    same = same and nan_ok
    pbuf = fused_gram._params_buffer(params, xp.device)
    want = fused_gram.logpdf_contraction_plain(xp, s2, ag, a, gsum, T, fam, pbuf)
    Tl = torch.tril(T)
    with full_f32():
        Ct = 0.5 * (ag @ a.T - gsum * (Tl + Tl.T - torch.diag(torch.diagonal(Tl))))
    _, dg, _ = fused_gram._map_vjp(fam, fused_gram._sqdist_plain(xp, xp, True), pbuf)
    mag = _xbar_mag(Ct * s2 * dg, xp, xp, 4.0)
    del Tl, Ct, dg
    err, ok = _bwd_compare("logpdf_contraction", got, want, mag, n, [n, d, q])
    plain = cuda_ms(lambda: fused_gram.logpdf_contraction_plain(xp, s2, ag, a, gsum, T, fam,
                                                                pbuf), 3)
    recs["logpdf_contraction"] = _bwd_record(
        "logpdf_contraction", err, ok and same,
        lambda: fused_gram.logpdf_contraction(*contr_in), plain,
        4.0 * (n * (n + 1) / 2 + 2 * n * d + 2 * n * q),
        sweep_flops(n, n, d, fam, True, 2 * q + 3, 4), [n, d, q])
    if bwd_in is not None:
        recs["gram_bwd"] = gram_bwd_checks(bwd_in)
    return recs


def gram_bwd_checks(bwd_in, tag="gram_bwd"):
    """Kernel 6 in each mode on the arguments of its first call of that mode
    in a run (``bwd_in``: mode → arguments): against its plain version, bit
    for bit against a second call, timed beside its bound. The symmetric
    single sweep (C + Cᵀ, the sum once per pair) and the cross gram's two
    passes; bytes: the cotangent read once, x, z read and x̄ written once.
    The record sums the modes' times (one run's calls) and lists each under
    "modes"."""
    from abstractgps_tpu_torch.ops import fused_gram

    modes = {}
    for mode in ("sym", "plain", "transpose"):
        if mode not in bwd_in:
            continue
        x_, z_, C, fam, params, sym, _ = bwd_in[mode]
        n, d = x_.shape
        m = z_.shape[0]
        got, same = _repeat(lambda: fused_gram.gram_bwd(*bwd_in[mode]), f"{tag} {mode}")
        pbuf = fused_gram._params_buffer(params, x_.device)
        want = fused_gram.gram_bwd_plain(x_, z_, C, fam, pbuf, sym, mode)
        Ct = C.T if mode == "transpose" else (C + C.T if mode == "sym" else C)
        _, dg, _ = fused_gram._map_vjp(fam, fused_gram._sqdist_plain(x_, z_, sym), pbuf)
        mag = _xbar_mag(Ct * dg, x_, z_, 2.0)
        del Ct, dg
        # (x̄, p̄) → compare as (p̄, x̄)
        err, ok = _bwd_compare(f"{tag} {mode}", got[::-1], want[::-1], mag, m, [n, m, d])
        plain = cuda_ms(lambda: fused_gram.gram_bwd_plain(x_, z_, C, fam, pbuf, sym, mode), 3)
        modes[mode] = _bwd_record(f"{tag} {mode}", err, ok and same,
                                  lambda: fused_gram.gram_bwd(*bwd_in[mode]), plain,
                                  4.0 * (n * m + (2 * n + m) * d),
                                  sweep_flops(n, m, d, fam, sym, int(sym), 1), [n, m, d])
    total = {k: (None if any(r[k] is None for r in modes.values())
                 else sum(r[k] for r in modes.values()))
             for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    return dict(total, max_abs_err=max(r["max_abs_err"] for r in modes.values()),
                library_ms=None, bound_by="bytes"
                if all(r["bound_by"] == "bytes" for r in modes.values()) else "operations",
                ok=all(r["ok"] for r in modes.values()) and len(modes) == 3, modes=modes)


class capture_first_input:
    """Record clones of the arguments of the first call of a kernel wrapper
    during a run, one record per value of ``key(args)`` (the wrapper still
    runs and counts its launch). ``value`` is the first argument of the
    first call."""

    def __init__(self, name, module="blocked_chol", key=lambda args: None):
        import importlib

        self.mod = importlib.import_module(f"abstractgps_tpu_torch.ops.{module}")
        self.name, self.key = name, key
        self.orig = getattr(self.mod, name)
        self.calls = {}

    @property
    def value(self):
        return next(iter(self.calls.values()))[0] if self.calls else None

    def __enter__(self):
        def spy(*args):
            k = self.key(args)
            if k not in self.calls:
                self.calls[k] = tuple(a.detach().clone() if hasattr(a, "detach") else a
                                      for a in args)
            return self.orig(*args)

        setattr(self.mod, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def profile_breakdown(name: str, fn, top: int = 10, setup=None) -> None:
    """One warm call of ``fn`` under ``torch.profiler``: device time by
    kernel name, and the device's busy share of the traced window (the
    union of kernel intervals over the span from the first traced host op
    to the last kernel's end; the profiler's own overhead widens it). With
    ``setup``, each call is ``fn(setup())`` and ``setup`` runs outside the
    window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def prepared():
        if setup is None:
            return fn
        arg = setup()
        return lambda: fn(arg)

    prepared()()
    call = prepared()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the top entries, then the port's own kernels further down
    shown = ranked[:top] + [kv for kv in ranked[top:] if any(
        s in kv[0] for s in ("agp::", "gram_tile_kernel", "split_sweep", "anonymous namespace"))]
    for kname, (t, n) in shown:
        print(f"[profile {name}]   {t / 1e3:9.3f} ms {t / device_us:6.3f} x{n:<5d} "
              f"{kname[:90]}", flush=True)


# ---------------------------------------------------------------------------
# The samplers: hyperparameter NUTS on the fused path, the switch to the
# library path, latent NUTS, ESS and SMC
# ---------------------------------------------------------------------------

# hyperparameter NUTS over the exact-GP logpdf (bench.py:256-281): N, D, chains,
# init jitter, warmup, draws, tree depth
HYPER = dict(n=2048, d=8, chains=2, jitter=0.05, warmup=8, draws=8, max_depth=5)
HYPER_KERNELS = ("gram_tile", "slab_factor", "tri_inv_block", "logpdf_contraction")
# latent-Poisson NUTS (bench.py:163-187)
LATENT = dict(n=256, chains=64, jitter=0.1, warmup=64, draws=64, max_depth=8)
# the latent chains must have mixed: largest R-hat over the 256 latents
RHAT_MAX = 1.1


def hyper_logdensity(x, y):
    """log p(y | σ², ℓ, noise) + log N(q; 0, I) at q = log(σ², ℓ, noise),
    σ²·Matérn-3/2 with lengthscale ℓ: the density of bench.py:260-264."""
    import torch

    import abstractgps_tpu_torch as agt

    def logdens(q):
        s2, ell, noise = torch.exp(q)
        k = s2 * agt.with_lengthscale(agt.Matern32Kernel(), ell)
        return agt.GP(k)(x, noise).logpdf(y) - 0.5 * torch.sum(q * q)
    return logdens


def kappa_f64(s2, ell, x, noise):
    """κ(K + noise·I) ≤ λ_max / noise, λ_max by power iteration, for
    σ²·Matérn-3/2 on the card in f64."""
    import torch

    with torch.no_grad():
        x64 = x.double()
        r2 = torch.cdist(x64, x64).square_()
        r2.fill_diagonal_(0.0)
        K = _matern32_f64(r2, s2, ell)
        del r2
        v = torch.ones(K.shape[0], dtype=torch.float64, device=x.device)
        for _ in range(50):
            v = K @ v
            v = v / v.norm()
        return (float(v @ (K @ v)) + noise) * 1.01 / noise


class OneStepTo:
    """Draws of one HMC transition of one leapfrog of unit step whose
    momentum lands the position on ``target``, accepted whenever the
    acceptance probability is above 0."""

    def __init__(self, q0, g0, target):
        self.p = target - q0 - 0.5 * g0

    def momentum(self, q):
        return self.p

    def trajectory_length(self, q, high):
        import torch

        return torch.ones(q.shape[0], dtype=torch.int64, device=q.device)

    def accept_uniform(self, q):
        import torch

        return torch.zeros(q.shape[0], dtype=q.dtype, device=q.device)


# the largest |dg/d(d²)| of the isotropic maps the sparse paths run (σ² is
# applied outside the gram kernel): SE 0.5, Matérn-3/2 1.5
GPRIME_MAX = {0: 0.5, 2: 1.5}


def gram_tile_tol(x, z, family) -> float:
    """Tolerance of ``gram_tile`` against its plain version on inputs of any
    scale: 8·eps·(max‖x‖² + max‖z‖²) in d², times the map's largest slope in
    K. Both sum (x − z)² in f32, the kernel by FMA, and differ by ≲
    (D + 1)·eps·d²."""
    nx = float((x.double() ** 2).sum(1).max())
    nz = float((z.double() ** 2).sum(1).max())
    return 8.0 * EPS32 * (nx + nz) * GPRIME_MAX[family]


def forward_kernel_check(name, args, gram_tol=None):
    """(max_abs_err, tol, shape) of ``gram_tile``, ``slab_factor`` or
    ``tri_inv_block`` against its plain version on one call's arguments.
    ``gram_tile``: 3e-5 where ``gram_tol`` says so (inputs in the unit cube,
    ℓ ≥ 0.8, as ``kernel_checks`` states), else ``gram_tile_tol``; the
    factor and the inverses at 10·κ·eps of their largest entry, κ of the
    slab and of the diagonal blocks in f64."""
    import torch

    from abstractgps_tpu_torch.ops import blocked_chol, fused_gram

    if name == "gram_tile":
        x_, z_, fam, params, *rest = args
        sym = bool(rest[0]) if rest else False
        pbuf = fused_gram._params_buffer(params, x_.device)
        err = float((fused_gram.gram_tile(x_, z_, fam, params, sym)
                     - fused_gram.gram_tile_plain(x_, z_, fam, pbuf, sym)).abs().max())
        tol = gram_tile_tol(x_, z_, fam) if gram_tol is None else gram_tol
        return err, tol, list(x_.shape[:1]) + list(z_.shape)
    if name == "slab_factor":
        S, B = args
        ev = torch.linalg.eigvalsh(S.double())
        Lk, Wk = blocked_chol.slab_factor(S, B)
        Lp, Wp = blocked_chol.slab_factor_plain(S, B)
        err = max(float((Lk - Lp).abs().max()), float((Wk - Wp).abs().max()))
        scale = max(float(Lp.abs().max()), float(Wp.abs().max()))
        return err, _tol_rel(float(ev[-1] / ev[0])) * scale, [S.shape[0], B]
    L, B = args
    nb = L.shape[0] // B
    blocks = torch.stack([L[i * B:(i + 1) * B, i * B:(i + 1) * B] for i in range(nb)])
    kb = float(torch.linalg.cond(blocks.double()).max())
    want = blocked_chol.tri_inv_block_plain(L, B)
    err = float((blocked_chol.tri_inv_block(L, B) - want).abs().max())
    return err, _tol_rel(kb) * float(want.abs().max()), [nb, B, B]


def gram_tile_timing(tag, args):
    """Device ms of one ``gram_tile`` call on ``args`` beside its bound
    (bytes: x and z read, the tile written once; operations as
    ``kernel_checks`` counts them), printed; returns dict(device_ms,
    bound_ms)."""
    from abstractgps_tpu_torch.ops import fused_gram

    (rows, d), cols = args[0].shape, args[1].shape[0]
    b_, by = bound_ms(4.0 * ((rows + cols) * d + rows * cols), rows * cols * (3.0 * d + 12.0))
    dev_tile = device_ms(lambda: fused_gram.gram_tile(*args))
    print(f"[kernel gram_tile] {tag} {[rows, cols, d]}: device time per call {_ms(dev_tile)} ms, "
          f"bound {b_:.4f} ms ({by})", flush=True)
    return dict(device_ms=dev_tile, bound_ms=b_)


def gram_matvec_check(args):
    """The fused CG matvec on the inputs the [cg] logpdf gave it (x̂, the
    (N, 33) block, the family, its hyperparameter buffer, σ², the noise,
    the panel): against its plain version within f32 rounding of N-term
    sums, 4·√N·eps32·(σ²·Σ_j |V_jc| + noise·|V_ic|) (|K₀| ≤ 1), bit for bit
    against a second call; its time with CUDA events and in device time
    (the sweep and its in-order sum), the plain version's, and the bound
    (operations: N²·(3D + 12 + 2q); bytes 4·(N·D + 2·N·q)). Printed;
    returns the kernel table's record."""
    import torch

    from abstractgps_tpu_torch.ops import matvec

    x, V, fam, buf, s2, nd, panel = args
    (n, d), q = x.shape, V.shape[1]
    got = matvec.gram_matvec_fused(*args)
    same = torch.equal(got, matvec.gram_matvec_fused(*args))
    want = matvec.gram_matvec_plain(*args)
    Va = V.abs().double()
    tol = 4.0 * math.sqrt(n) * EPS32 * (float(s2) * Va.sum(0)[None, :]
                                        + nd.double()[:, None] * Va)
    excess = float(((got.double() - want.double()).abs() / tol).max())
    err = float((got - want).abs().max())
    ms = cuda_ms(lambda: matvec.gram_matvec_fused(*args), 20)
    plain = cuda_ms(lambda: matvec.gram_matvec_plain(*args), 1)
    dev = device_ms(lambda: matvec.gram_matvec_fused(*args))
    b_, by = bound_ms(4.0 * (n * d + 2.0 * n * q), n * n * (3.0 * d + 12.0 + 2.0 * q))
    ok = same and excess <= 1.0
    print(f"[kernel gram_matvec] cg {[n, d, q]}: max_abs_err {err:.3e} (largest error / its "
          f"tolerance {excess:.3f}); a second call bit for bit: {same}; {ms:.4f} ms, device "
          f"time per call {_ms(dev)} ms, plain {plain:.4f} ms, bound {b_:.4f} ms ({by}); "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return dict(max_abs_err=err, tol="4·√N·eps32·Σ|terms|", shape=[n, d, q], ok=ok, ms=ms,
                plain_ms=plain, library_ms=None, device_ms=dev, bound_ms=b_, bound_by=by)


def report_checks(tag, out):
    """Print each (error, tolerance, shape[, ok]) of ``out`` under ``tag``;
    returns name → dict(max_abs_err, shape, ok)."""
    res = {}
    for name, (err, tol, shape, *flag) in out.items():
        ok = flag[0] if flag else err <= tol
        print(f"[{tag} kernel {name}] shape {shape}: max_abs_err {err:.3e} (tol "
              f"{tol if isinstance(tol, str) else f'{tol:.3e}'}) {'ok' if ok else 'FAIL'}",
              flush=True)
        res[name] = dict(max_abs_err=err, shape=shape, ok=ok)
    return res


def hyper_kernel_checks(captured, tag="mcmc hyper"):
    """Kernels 1, 2, 4 and 5 against their plain versions on the inputs of
    the first ∇logpdf of hyperparameter NUTS (``captured``: name → first
    call's arguments). Tolerances as in ``kernel_checks``, κ of the slab and
    of the diagonal blocks in f64."""
    out = {name: forward_kernel_check(name, captured[name], gram_tol=3e-5)
           for name in ("gram_tile", "slab_factor", "tri_inv_block")}
    recs = backward_kernel_checks(captured["logpdf_contraction"])
    r = recs["logpdf_contraction"]
    out["logpdf_contraction"] = (r["max_abs_err"], "x̄ within 2·√n·eps·Σ|terms|, scalars 1e-4",
                                 r["shape"], r["ok"])
    return report_checks(tag, out)


def run_hyper_nuts(seed, dev):
    """[mcmc hyper] and [mcmc set_enabled]: hyperparameter NUTS at the
    configuration of bench.py:256-281 on the fused path
    (``chain_eval="loop"``), then the same ∇logpdf with both kernel modules
    switched off. Returns (ok, the run's launches, the kernels' checks)."""
    import numpy as np
    import torch

    from abstractgps_tpu_torch.inference.mcmc import (
        HMCState,
        hmc_kernel,
        init_chain_positions,
        logdensity_and_grad,
        nuts_kernel,
        run_mcmc,
    )
    from abstractgps_tpu_torch.ops import blocked_chol, fused_gram

    c = HYPER
    rng = np.random.default_rng(seed + 10)
    x = torch.as_tensor(rng.uniform(size=(c["n"], c["d"])), dtype=torch.float32, device=dev)
    y = torch.as_tensor(rng.normal(size=c["n"]), dtype=torch.float32, device=dev)
    logdens = hyper_logdensity(x, y)
    evals = [0]

    def counted(q):
        evals[0] += 1
        return logdens(q)

    init = init_chain_positions(seed, torch.zeros(3, dtype=torch.float32, device=dev),
                                num_chains=c["chains"], jitter=c["jitter"])
    f = logdensity_and_grad(logdens, lambda v: v, "loop")
    q0 = init[:1]
    ok = True

    # one ∇logpdf (one chain's leapfrog) at chain 0's initial q: the kernels'
    # inputs, the launches per leapfrog, the gradient against f64
    with capture_first_input("gram_tile", "fused_gram") as c1, \
            capture_first_input("slab_factor") as c2, \
            capture_first_input("tri_inv_block") as c4, \
            capture_first_input("logpdf_contraction", "fused_gram") as c5:
        reset_launches()
        ld0, g0 = f(q0)
        torch.cuda.synchronize()
        per_leapfrog = read_launches()
    captured = {"gram_tile": c1.calls.get(None), "slab_factor": c2.calls.get(None),
                "tri_inv_block": c4.calls.get(None), "logpdf_contraction": c5.calls.get(None)}
    print(f"[mcmc hyper] N={c['n']} D={c['d']} f32: launches of one ∇logpdf (one chain's "
          f"leapfrog) {json.dumps(per_leapfrog)}", flush=True)
    th = [float(v) for v in torch.exp(q0[0].double())]
    kappa = kappa_f64(th[0], th[1], x, th[2])
    want = grad_oracle_f64(th[0], th[1], x, y, noise=th[2]).double()
    want = want * torch.tensor(th, dtype=torch.float64) - q0[0].double().cpu()
    got = g0[0].double().cpu()
    tol = 10.0 * kappa * EPS32
    rel = float((got - want).abs().max() / want.abs().max())
    g_ok = bool(torch.isfinite(got).all()) and rel <= tol
    print(f"[mcmc hyper] ∇logpdf at q0 {[round(v, 6) for v in got.tolist()]} (f64 "
          f"{[round(v, 6) for v in want.tolist()]}); max error / max|∇| {rel:.3e}; "
          f"kappa<= {kappa:.3e}; tol {tol:.3e}; {'ok' if g_ok else 'FAIL'}", flush=True)
    ok = ok and g_ok

    # a non-PD f32 gram (huge ℓ, tiny noise) on the fused path: no raise, a
    # non-finite logpdf; the sampler's guard makes it −inf with a zero
    # gradient, and a leapfrog that lands there is rejected
    q_bad = torch.tensor([0.0, math.log(50.0), math.log(1e-9)], dtype=torch.float32, device=dev)
    qb = q_bad.clone().requires_grad_()
    raw = logdens(qb)
    (raw_g,) = torch.autograd.grad(raw, qb)
    ld_b, g_b = f(q_bad[None])
    state = HMCState(q0, ld0, g0)
    new, (ap, acc, _) = hmc_kernel(f, 1)(OneStepTo(q0, g0, q_bad[None]), state, 1.0,
                                         torch.ones(3, dtype=torch.float32, device=dev))
    rej_ok = (not bool(torch.isfinite(raw)) and float(ld_b[0]) == -math.inf
              and bool((g_b == 0).all()) and float(ap[0]) == 0.0 and not bool(acc[0])
              and torch.equal(new.q, q0))
    print(f"[mcmc hyper] q=(0, log 50, log 1e-9): logpdf {float(raw.detach())} (no raise; grad "
          f"{raw_g.tolist()}), guarded {float(ld_b[0])}, grad {g_b[0].tolist()}; a leapfrog "
          f"landing there: accept prob {float(ap[0])}, accepted {bool(acc[0])}; "
          f"{'ok' if rej_ok else 'FAIL'}", flush=True)
    ok = ok and rej_ok

    # the run; peak device memory after one ∇logpdf and after the run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    f(q0)
    torch.cuda.synchronize()
    peak_one = torch.cuda.max_memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    res = run_mcmc(counted, init, seed + 1, num_chains=c["chains"], num_samples=c["draws"],
                   num_warmup=c["warmup"], max_depth=c["max_depth"], chain_eval="loop")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_run = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(res.logdens).all())
    mem_ok = peak_run <= 1.1 * peak_one
    missing = [k for k in HYPER_KERNELS if launches[k] == 0]
    draws = c["chains"] * c["draws"]
    print(f"[mcmc hyper] {c['chains']} chains, {c['warmup']} warmup + {c['draws']} draws, "
          f"max_depth {c['max_depth']}, chain_eval loop: every draw's logdensity finite "
          f"{finite}; mean accept prob {float(res.accept_prob.mean()):.4f}; leapfrog steps of "
          f"the draws {int(res.num_steps.sum())}; ∇logpdf evaluations (warmup included) "
          f"{evals[0]}; divergences {int(res.diverging.sum())}; step sizes "
          f"{res.step_size.tolist()}; wall {wall:.3f} s, {draws / wall:.3f} draws/s, "
          f"{evals[0] / wall:.3f} leapfrogs/s (one chain's leapfrog = one ∇logpdf); "
          f"launches {json.dumps(launches)}; peak device memory after one ∇logpdf "
          f"{peak_one} B, after the run {peak_run} B ({peak_run / peak_one:.4f}x)", flush=True)
    hyper_ok = finite and mem_ok and not missing
    if not hyper_ok:
        print(f"[mcmc hyper] FAIL: finite {finite}, memory within 10% {mem_ok}, kernels not "
              f"launched {missing}", flush=True)
    ok = ok and hyper_ok
    # one transition at the adapted step sizes, traced: the device's busy share
    last = res.positions[:, -1].contiguous()
    state = HMCState(last, *f(last))
    kern = nuts_kernel(f, max_depth=c["max_depth"])
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    profile_breakdown("mcmc hyper transition",
                      lambda: kern(gen, state, res.step_size, res.inv_mass), top=6)
    with torch.no_grad():
        checks = hyper_kernel_checks(captured)
    ok = ok and all(r["ok"] for r in checks.values())

    # [mcmc set_enabled]: both modules off → the library path, no launch
    blocked_chol.set_enabled(False)
    fused_gram.set_enabled(False)
    try:
        reset_launches()
        ld_off, g_off = f(q0)
        torch.cuda.synchronize()
        off_launches = read_launches()
    finally:
        blocked_chol.set_enabled(True)
        fused_gram.set_enabled(True)
    err_ld = abs(float(ld_off[0]) - float(ld0[0])) / abs(float(ld0[0]))
    err_g = float((g_off - g0).abs().max() / g0.abs().max())
    off_ok = (all(v == 0 for v in off_launches.values()) and err_ld <= tol and err_g <= tol)
    print(f"[mcmc set_enabled] logpdf {float(ld_off[0]):.6f} (kernel path "
          f"{float(ld0[0]):.6f}), rel error {err_ld:.3e}; ∇ max error / max|∇| {err_g:.3e}; "
          f"tol {tol:.3e}; launches {json.dumps(off_launches)}; "
          f"{'ok' if off_ok else 'FAIL'}", flush=True)
    ok = ok and off_ok
    return ok, launches, checks


def run_latent_nuts(seed, dev):
    """[mcmc latent]: latent-Poisson NUTS at the configuration of
    bench.py:163-187 (``chain_eval="vmap"``); it launches no port kernel."""
    import numpy as np
    import torch

    from abstractgps_tpu_torch.inference.mcmc import (
        HMCState,
        diagnostics,
        init_chain_positions,
        logdensity_and_grad,
        nuts_kernel,
        run_mcmc,
    )

    c = LATENT
    n = c["n"]
    rng = np.random.default_rng(seed + 20)
    xl = rng.uniform(size=(n, 1))
    t = np.sqrt(3.0) * np.abs(xl - xl.T)
    # the data in f64 on the host, as the benchmark draws them
    Ll_h = np.linalg.cholesky((1.0 + t) * np.exp(-t) + 1e-8 * np.eye(n))
    u_h = 2.0 + Ll_h @ rng.normal(size=n)
    y = torch.as_tensor(rng.poisson(np.exp(np.clip(u_h, -10, 8))), dtype=torch.float32,
                        device=dev)
    Ll = torch.as_tensor(Ll_h, dtype=torch.float32, device=dev)

    def logjoint(v):
        u = 2.0 + Ll @ v
        return -0.5 * torch.sum(v * v) + torch.sum(y * u - torch.exp(u) - torch.lgamma(y + 1.0))

    init = init_chain_positions(seed, torch.zeros(n, dtype=torch.float32, device=dev),
                                num_chains=c["chains"], jitter=c["jitter"])
    reset_launches()
    t0 = time.perf_counter()
    res = run_mcmc(logjoint, init, seed + 1, num_chains=c["chains"], num_samples=c["draws"],
                   num_warmup=c["warmup"], max_depth=c["max_depth"], chain_eval="vmap")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    finite = bool(torch.isfinite(res.logdens).all())
    rh = diagnostics.rhat_tree(res.positions)
    es = diagnostics.ess_tree(res.positions)
    draws = c["chains"] * c["draws"]
    no_launch = all(v == 0 for v in launches.values())
    mixed = float(np.max(rh)) < RHAT_MAX
    ok = finite and no_launch and mixed
    print(f"[mcmc latent] n_lat={n}, {c['chains']} chains, {c['warmup']} warmup + "
          f"{c['draws']} draws, max_depth {c['max_depth']}, chain_eval vmap: every draw's "
          f"logdensity finite {finite}; mean accept prob {float(res.accept_prob.mean()):.4f}; "
          f"leapfrog steps of the draws {int(res.num_steps.sum())}; divergences "
          f"{int(res.diverging.sum())}; wall {wall:.3f} s, {draws / wall:.3f} draws/s; R-hat "
          f"max {float(np.max(rh)):.4f} (< {RHAT_MAX}: {mixed}) median "
          f"{float(np.median(rh)):.4f}; bulk ESS min "
          f"{float(np.min(es)):.1f} median {float(np.median(es)):.1f}; no port kernel "
          f"launched (pure torch) {no_launch}; {'ok' if ok else 'FAIL'}", flush=True)
    # one transition at the adapted step sizes, traced: the device's busy share
    f = logdensity_and_grad(logjoint, lambda v: v, "vmap")
    last = res.positions[:, -1].contiguous()
    state = HMCState(last, *f(last))
    kern = nuts_kernel(f, max_depth=c["max_depth"])
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    with torch.no_grad():
        profile_breakdown("mcmc latent transition",
                          lambda: kern(gen, state, res.step_size, res.inv_mass), top=6)
    return ok


def run_ess_smc(seed, dev):
    """[ess]: elliptical slice sampling of a LatentGP Poisson model at
    n = 256; [smc]: the conjugate Gaussian of tests/test_ess_smc.py:55
    against its closed form (the tolerances of that test)."""
    import numpy as np
    import torch

    import abstractgps_tpu_torch as agt
    from abstractgps_tpu_torch import distributions as dist
    from abstractgps_tpu_torch.inference.mcmc import run_ess, run_smc

    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    n = 256
    x = torch.sort(torch.rand(n, generator=gen, device=dev)).values
    k = agt.with_lengthscale(agt.Matern32Kernel(), 0.2).to(device=dev, dtype=torch.float32)
    lfx = agt.LatentGP(agt.GP(k), lambda f: dist.Poisson(torch.exp(f)), 1e-3)(x)
    truth = lfx.rand(gen)
    prior = lfx.fx.to_mvnormal()

    def loglik(u):
        return torch.sum(lfx.lik(u).logpdf(truth["y"]))

    reset_launches()
    t0 = time.perf_counter()
    qs, lls = run_ess(loglik, prior.sample, torch.zeros(n, device=dev), gen, num_samples=200,
                      num_burnin=100, num_chains=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(qs).all()) and bool(torch.isfinite(lls).all())
    corr = float(np.corrcoef(qs.reshape(-1, n).mean(0).double().cpu().numpy(),
                             truth["f"].detach().double().cpu().numpy())[0, 1])
    ess_ok = finite and qs.shape == (4, 200, n)
    print(f"[ess] LatentGP Poisson n={n}, 4 chains, 100 burn-in + 200 draws: finite {finite}; "
          f"corr(posterior mean, true f) {corr:.4f}; wall {wall:.3f} s, "
          f"{800 / wall:.3f} draws/s; launches {json.dumps(read_launches())}; "
          f"{'ok' if ess_ok else 'FAIL'}", flush=True)

    dim, s2 = 3, 0.5
    y = torch.as_tensor(np.random.default_rng(seed + 31).normal(size=dim), dtype=torch.float32,
                        device=dev)

    def logprior(q):
        return -0.5 * torch.sum(q * q) - 0.5 * dim * math.log(2 * math.pi)

    def loglik_g(q):
        return -0.5 * torch.sum((q - y) ** 2) / s2 - 0.5 * dim * math.log(2 * math.pi * s2)

    particles0 = torch.randn((2048, dim), generator=gen, device=dev)
    t0 = time.perf_counter()
    res = run_smc(logprior, loglik_g, particles0, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    post_var = 1.0 / (1.0 + 1.0 / s2)
    yh = y.double().cpu().numpy()
    mean_cf, mean = post_var * yh / s2, res.particles.double().mean(0).cpu().numpy()
    var = res.particles.double().var(0, unbiased=False).cpu().numpy()
    log_z = float(-0.5 * np.sum(yh ** 2) / (1 + s2) - 0.5 * dim * np.log(2 * np.pi * (1 + s2)))
    smc_ok = (bool(np.all(np.abs(mean - mean_cf) <= 0.08))
              and bool(np.all(np.abs(var - post_var) <= 0.08))
              and abs(float(res.log_evidence) - log_z) <= 0.15)
    print(f"[smc] conjugate Gaussian, 2048 particles, dim {dim}: posterior mean "
          f"{np.round(mean, 4).tolist()} (closed form {np.round(mean_cf, 4).tolist()}), var "
          f"{np.round(var, 4).tolist()} (closed form {post_var:.4f}), log evidence "
          f"{float(res.log_evidence):.4f} (closed form {log_z:.4f}), {res.num_stages} stages; "
          f"tol 0.08 / 0.08 / 0.15; wall {wall:.3f} s; {'ok' if smc_ok else 'FAIL'}", flush=True)
    return ess_ok and smc_ok


# ---------------------------------------------------------------------------
# The sparse slice at BASELINE.json config 3: SVGP training, the collapsed
# VFE/DTC bound and the sparse posterior's updates, streaming conditioning
# ---------------------------------------------------------------------------

# BASELINE.json config 3 ("Sparse VFE GP: 50k points, 512 inducing points,
# SE-ARD kernel, ELBO optimization"), examples/sparse_vfe_50k.py: n points
# in D dimensions, M inducing points, the minibatch and Adam's learning rate;
# 20 joint steps and 5 natural-gradient steps (the example runs 2000), one
# ∇ at M = 1024, 4096 test points, 2048 new observations, 64 new
# pseudo-points
SPARSE = dict(n=50_000, d=8, m=512, batch=2048, lr=3e-2, steps=20, natgrad_steps=5,
              m_big=1024, test=4096, new_obs=2048, new_z=64)
# streaming conditioning: 16 extends of 512 into a cache of capacity 8192
ONLINE = dict(cap=8192, b=512, test=4096, noise=0.1)
JITTER = 1e-6  # the inducing jitter of svgp_init and of the example's f(z, 1e-6)
# launches per joint SVGP Adam step at M = 512 (the fused gram's gate is
# ≥ 512² pairs, so Kzz is on it) and per online extend
SVGP_STEP_LAUNCHES = {"gram_tile": 2, "gram_bwd": 3}
ONLINE_EXTEND_LAUNCHES = {"gram_tile": 2, "tri_inv_block": 1}
# the f32 gradients of the sparse paths chain a factor, its solves and its
# pullback, each ≲ κ·eps, and sums of thousands of terms: 100·κ·eps of each
# leaf's largest entry (CPU f32 runs of the same shapes erred ≲ 5·κ·eps)
GRAD_KAPPA_FACTOR = 100.0


def _sym_key(args):
    """``gram_tile``'s ``symmetric`` flag, the key of its captured calls."""
    return bool(args[4]) if len(args) > 4 else False


def sparse_data(seed, dev, n, d):
    """The data of ``examples/sparse_vfe_50k.py``, drawn on the card from
    ``seed``: x ~ U[0, 4]^D, f = sin(x)·w + 0.3·cos(2x₀) with w_k = e^{−k/2},
    y = f + 0.2·ε. Returns (x, y, the generator)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((n, d), generator=gen, device=dev) * 4.0
    w = torch.exp(-torch.arange(d, device=dev, dtype=torch.float32) / 2.0)
    f = torch.sin(x) @ w + 0.3 * torch.cos(2.0 * x[:, 0])
    return x, f + 0.2 * torch.randn(n, generator=gen, device=dev), gen


def ard_kernel(s2, ard):
    """σ²·SE ∘ ARDTransform(1/ℓ), the example's kernel."""
    import abstractgps_tpu_torch as agt

    return agt.compose(agt.SqExponentialKernel(), agt.ARDTransform(1.0 / ard)) * s2


def se_ard_f64(a, b, s2, ard):
    """σ²·exp(−½‖(a − b)/ℓ‖²) in f64 from ``torch.cdist``, written apart from
    the port."""
    import torch

    return s2 * torch.exp(-0.5 * torch.cdist(a.double() / ard, b.double() / ard).square())


def _softplus64(v):
    import torch

    return torch.logaddexp(v, torch.zeros_like(v))


def svgp_elbo_f64(s2, ard, noise, z, m, c_raw, xb, yb, n_total):
    """The uncollapsed SVGP ELBO in f64 on the card, written apart from the
    port: dense Kzz, its Cholesky, A = Lz⁻¹Kzx, q(ε) = N(m, CCᵀ)."""
    import torch

    M = z.shape[0]
    eye = torch.eye(M, dtype=torch.float64, device=z.device)
    Lz = torch.linalg.cholesky(se_ard_f64(z, z, s2, ard) + JITTER * eye)
    A = torch.linalg.solve_triangular(Lz, se_ard_f64(z, xb, s2, ard), upper=False)
    C = torch.tril(c_raw, -1) + torch.diag(_softplus64(torch.diagonal(c_raw)))
    mu = A.T @ m
    CtA = C.T @ A
    var = torch.clamp(s2 - (A * A).sum(0) + (CtA * CtA).sum(0), min=0.0)
    ell = (-0.5 * (torch.log(2.0 * math.pi * noise) + (yb.double() - mu) ** 2 / noise)
           - var / (2.0 * noise))
    kl = 0.5 * ((C * C).sum() + m @ m - M - 2.0 * torch.log(torch.diagonal(C)).sum())
    return n_total / xb.shape[0] * ell.sum() - kl


def vfe_f64(s2, ard, noise, z, x, y, xt=None):
    """Titsias's collapsed bound in f64 on the card, written apart from the
    port, from A = Lz⁻¹Kzx/σ and Λ = I + AAᵀ:
    log N(y; 0, Qff + σ²I) = −½(n log 2π + n log σ² + log|Λ| + (‖y‖² −
    ‖L_Λ⁻¹Ay‖²)/σ²) is the DTC objective, the ELBO subtracts
    (n·σ² − σ²‖A‖²_F)/(2σ²). Returns (elbo, dtc, κ(Kzz + jitter), κ(Λ)) and,
    with ``xt``, the VFE posterior's mean and variance there."""
    import torch

    M, n = z.shape[0], x.shape[0]
    eye = torch.eye(M, dtype=torch.float64, device=z.device)
    Kzz = se_ard_f64(z, z, s2, ard) + JITTER * eye
    Lz = torch.linalg.cholesky(Kzz)
    sig = torch.sqrt(noise)
    A = torch.linalg.solve_triangular(Lz, se_ard_f64(z, x, s2, ard), upper=False) / sig
    Lam = eye + A @ A.T
    LL = torch.linalg.cholesky(Lam)
    yd = y.double()
    c = torch.linalg.solve_triangular(LL, (A @ yd)[:, None], upper=False)[:, 0] / sig
    quad = (yd @ yd) / noise - c @ c
    dtc = -0.5 * (n * math.log(2 * math.pi) + n * torch.log(noise)
                  + 2.0 * torch.log(torch.diagonal(LL)).sum() + quad)
    elbo = dtc - 0.5 * (n * s2 / noise - (A * A).sum())
    with torch.no_grad():
        ek, el = torch.linalg.eigvalsh(Kzz), torch.linalg.eigvalsh(Lam)
        kappas = float(ek[-1] / ek[0]), float(el[-1] / el[0])
    if xt is None:
        return elbo, dtc, *kappas
    with torch.no_grad():
        As = torch.linalg.solve_triangular(Lz, se_ard_f64(z, xt, s2, ard), upper=False)
        alpha = torch.cholesky_solve((A @ yd)[:, None] / sig, LL)[:, 0]
        mean = As.T @ alpha
        V = torch.linalg.solve_triangular(LL, As, upper=False)
        var = torch.clamp(s2 - (As * As).sum(0) + (V * V).sum(0), min=0.0)
    return elbo, dtc, *kappas, mean, var


def leaf_errors(got, want):
    """Per leaf: max|got − want| / max|want|."""
    return [float((g.double().cpu() - w.double().cpu()).abs().max()
                  / w.double().abs().max().cpu()) for g, w in zip(got, want)]


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def run_svgp(seed, dev):
    """[svgp]: 20 joint Adam steps of the example's loss (σ², the ARD
    lengthscales, the noise, z, m and C_raw from a constrained tree, the
    SVGP rebuilt from it each step) through ``fit``, at the full width of
    config 3; 5 ``fit_svgp_natgrad`` steps; one ∇ of the ELBO at
    M = 1024 against f64. Returns (ok, the fitted constrained tree, launches
    by run, the kernels' checks by name)."""
    import torch

    import abstractgps_tpu_torch as agt
    import abstractgps_tpu_torch.params as P

    c = SPARSE
    n, d, M, B = c["n"], c["d"], c["m"], c["batch"]
    x, y, gen = sparse_data(seed + 40, dev, n, d)
    z0 = x[torch.randperm(n, generator=gen, device=dev)[:M]].clone()
    template = agt.svgp_init(agt.SqExponentialKernel(), z0)
    theta0 = {"s2": P.positive(torch.tensor(1.0, device=dev)),
              "ard": P.positive(torch.ones(d, device=dev)),
              "noise2": P.positive(torch.tensor(0.1, device=dev)),
              "z": z0, "m": template.m, "C_raw": template.C_raw}

    def build(cc):
        return template.replace(kernel=ard_kernel(cc["s2"], cc["ard"]), z=cc["z"], m=cc["m"],
                                C_raw=cc["C_raw"])

    marks = []  # (launches, host time) at the start of each step's loss

    def loss(raw):
        marks.append((read_launches(), time.perf_counter()))
        idx = torch.randint(0, n, (B,), generator=gen, device=dev)
        cc = P.constrain(raw)
        return -agt.svgp_elbo(build(cc), x[idx], y[idx], cc["noise2"], n_total=n)

    ok = True
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = agt.fit(loss, theta0, num_steps=c["steps"], learning_rate=c["lr"])
    elbo = (-res.history).double().cpu()
    t1 = time.perf_counter()
    marks.append((read_launches(), t1))
    per_step = [_diff(marks[i + 1][0], marks[i][0]) for i in range(c["steps"])]
    want = {k: SVGP_STEP_LAUNCHES.get(k, 0) for k in per_step[0]}
    steps_ok = all(s == want for s in per_step)
    fit_launches = marks[-1][0]
    warm = (c["steps"] - 1) / (t1 - marks[1][1])
    fit_ok = bool(torch.isfinite(elbo).all()) and steps_ok
    print(f"[svgp] n={n} D={d} M={M} B={B} f32, Adam lr {c['lr']}: {c['steps']} joint steps "
          f"in {t1 - t0:.3f} s ({c['steps'] / (t1 - t0):.3f} steps/s; steps 2-{c['steps']} "
          f"{warm:.3f} steps/s); minibatch ELBO first {float(elbo[0]):.3f} last "
          f"{float(elbo[-1]):.3f}; launches per step {json.dumps(per_step[0])} (predicted "
          f"{json.dumps(SVGP_STEP_LAUNCHES)}, every step as predicted: {steps_ok}); "
          f"{'ok' if fit_ok else 'FAIL'}", flush=True)
    ok = ok and fit_ok
    # the kernels on the inputs of one more step's forward and backward at
    # the fitted tree (at the first step q(ε) is the prior, where the gram
    # cotangents vanish)
    with capture_first_input("gram_tile", "fused_gram", key=_sym_key) as c1, \
            capture_first_input("gram_bwd", "fused_gram", key=lambda a: a[6]) as c6:
        torch.autograd.grad(loss(res.params), P.leaves(res.params))
    checks = {name: forward_kernel_check("gram_tile", args)
              for name, args in (("gram_tile sym", c1.calls.get(True)),
                                 ("gram_tile cross", c1.calls.get(False))) if args is not None}
    with torch.no_grad():
        bwd = gram_bwd_checks(c6.calls, tag="svgp gram_bwd")
    checks["gram_bwd"] = (bwd["max_abs_err"], "x̄ within 2·√m·eps·Σ|terms|, scalars 1e-4",
                          {m_: r["shape"] for m_, r in bwd["modes"].items()}, bwd["ok"])
    fitted = {k: v.detach() for k, v in P.constrain(res.params).items()}

    # natural-gradient steps on q(ε), Adam on z, from the fitted state
    sv = build(fitted)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    _, trace = agt.fit_svgp_natgrad(seed + 42, sv, x, y, fitted["noise2"], batch_size=B,
                                    steps=c["natgrad_steps"])
    trace = trace.double().cpu()
    t_ng = time.perf_counter() - t0
    ng_launches = read_launches()
    ng_ok = bool(torch.isfinite(trace).all())
    print(f"[svgp natgrad] {c['natgrad_steps']} fit_svgp_natgrad steps in {t_ng:.3f} s "
          f"({c['natgrad_steps'] / t_ng:.3f} steps/s); ELBO trace {trace.tolist()}; launches "
          f"{json.dumps(ng_launches)}; {'ok' if ng_ok else 'FAIL'}", flush=True)
    ok = ok and ng_ok

    # one ∇ at M = 1024: chol(Kzz) through slab_factor, the whitening solve
    # through the wide solve; q(ε) away from the prior (at m = 0, C = I the
    # ELBO does not depend on z)
    Mb = c["m_big"]
    g2 = torch.Generator(device=dev).manual_seed(seed + 43)
    z1 = x[torch.randperm(n, generator=g2, device=dev)[:Mb]]
    m1 = 0.3 * torch.randn(Mb, generator=g2, device=dev)
    C1 = (torch.tril(0.02 * torch.randn((Mb, Mb), generator=g2, device=dev), -1)
          + 0.5 * torch.eye(Mb, device=dev))
    c_raw1 = agt.models.svgp.set_variational(template, m1, C1).C_raw
    idx = torch.randint(0, n, (B,), generator=g2, device=dev)
    vals = [fitted["s2"], fitted["ard"], fitted["noise2"], z1, m1, c_raw1]
    leaves = [v.detach().clone().requires_grad_() for v in vals]
    with capture_first_input("slab_factor") as c2, capture_first_input("tri_inv_block") as c4:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        s2, ard, noise, z, mv, cr = leaves
        sv1 = agt.SVGP(None, ard_kernel(s2, ard), z, mv, cr,
                       torch.tensor(JITTER, device=dev))
        val = -agt.svgp_elbo(sv1, x[idx], y[idx], noise, n_total=n)
        got = torch.autograd.grad(val, leaves)
        torch.cuda.synchronize()
        t_big = time.perf_counter() - t0
        big_launches = read_launches()
    l64 = [v.detach().double().requires_grad_() for v in vals]
    val64 = -svgp_elbo_f64(*l64, x[idx], y[idx], n)
    want = torch.autograd.grad(val64, l64)
    with torch.no_grad():
        ev = torch.linalg.eigvalsh(se_ard_f64(z1, z1, l64[0], l64[1])
                                   + JITTER * torch.eye(Mb, dtype=torch.float64, device=dev))
    kappa = float(ev[-1] / ev[0])
    tol = GRAD_KAPPA_FACTOR * kappa * EPS32
    errs = leaf_errors(got, want)
    val_err = abs(float(val.detach()) - float(val64.detach())) / abs(float(val64.detach()))
    big_ok = (all(e <= tol for e in errs) and val_err <= _tol_rel(kappa)
              and big_launches["slab_factor"] > 0)
    names = ("s2", "ard", "noise", "z", "m", "C_raw")
    print(f"[svgp M={Mb}] ∇ of the minibatch ELBO in {t_big * 1e3:.3f} ms: -ELBO "
          f"{float(val.detach()):.4f} (f64 {float(val64.detach()):.4f}, rel error "
          f"{val_err:.3e}, tol {_tol_rel(kappa):.3e}); kappa(Kzz + jitter) {kappa:.3e}; "
          f"gradient error / max|∇| by leaf {json.dumps(dict(zip(names, errs)))}, tol "
          f"{tol:.3e}; launches {json.dumps(big_launches)}; {'ok' if big_ok else 'FAIL'}",
          flush=True)
    ok = ok and big_ok
    for name, cap in (("slab_factor", c2), ("tri_inv_block", c4)):
        if cap.value is not None:
            checks[name] = forward_kernel_check(name, cap.calls[None])
    checks = report_checks("svgp", checks)
    ok = ok and all(r["ok"] for r in checks.values())
    profile_breakdown("svgp step", lambda: torch.autograd.grad(
        loss(res.params), P.leaves(res.params)), top=8)
    runs = {"svgp fit": fit_launches, "svgp natgrad": ng_launches, f"svgp M={Mb}": big_launches}
    return ok, fitted, runs, checks


def run_sparse(seed, dev, fitted):
    """[sparse]: the collapsed bound ``elbo(VFE(f(z, 1e-6)), f(x, σ²), y)``
    on all 50 000 points at [svgp]'s fitted σ², ARD, noise and z, and its
    gradient with respect to them, against ``vfe_f64``; the DTC objective;
    ``posterior(VFE)`` with ``mean_and_var`` at 4096 test points; both
    ``update_posterior`` paths against the batch posterior. Returns (ok,
    launches by run, the kernels' checks by name)."""
    import torch

    import abstractgps_tpu_torch as agt

    c = SPARSE
    n, d = c["n"], c["d"]
    x, y, gen = sparse_data(seed + 40, dev, n, d)
    vals = [fitted["s2"], fitted["ard"], fitted["noise2"], fitted["z"]]
    leaves = [v.detach().clone().requires_grad_() for v in vals]
    s2, ard, noise, z = leaves

    def collapsed(kind="elbo"):
        f = agt.GP(ard_kernel(s2, ard))
        approx = (agt.VFE if kind == "elbo" else agt.DTC)(f(z, JITTER))
        return agt.approx_log_evidence(approx, f(x, noise), y)

    ok = True
    with capture_first_input("gram_tile", "fused_gram", key=_sym_key) as c1, \
            capture_first_input("gram_bwd", "fused_gram", key=lambda a: a[6]) as c6:
        torch.cuda.synchronize()
        reset_launches()
        e = collapsed()
        # the backward runs after `precise` has restored the flags: read the
        # TF32 flag from inside it
        tf32 = []
        e.register_hook(lambda g: tf32.append(torch.backends.cuda.matmul.allow_tf32))
        got = torch.autograd.grad(e, leaves)
        torch.cuda.synchronize()
        grad_launches = read_launches()
    l64 = [v.detach().double().requires_grad_() for v in vals]
    e64, dtc64, k_zz, k_lam = vfe_f64(*l64, x, y)
    want = torch.autograd.grad(e64, l64)
    kappa = max(k_zz, k_lam)
    errs = leaf_errors(got, want)
    e_err = abs(float(e.detach()) - float(e64.detach())) / abs(float(e64.detach()))
    tol_g = GRAD_KAPPA_FACTOR * kappa * EPS32
    grad_ok = all(g <= tol_g for g in errs) and e_err <= _tol_rel(kappa)
    print(f"[sparse] collapsed ELBO at n={n} M={z.shape[0]} f32: {float(e.detach()):.4f} (f64 "
          f"{float(e64.detach()):.4f}, rel error {e_err:.3e}, tol {_tol_rel(kappa):.3e}); "
          f"kappa(Kzz + jitter) {k_zz:.3e}, kappa(Lambda) {k_lam:.3e}; gradient error / max|∇| "
          f"by leaf {json.dumps(dict(zip(('s2', 'ard', 'noise', 'z'), errs)))}, tol "
          f"{tol_g:.3e}; allow_tf32 during the backward {tf32[0]}; launches "
          f"{json.dumps(grad_launches)}; {'ok' if grad_ok else 'FAIL'}", flush=True)
    ok = ok and grad_ok and not tf32[0]
    checks = {name: forward_kernel_check("gram_tile", args)
              for name, args in (("gram_tile sym", c1.calls.get(True)),
                                 ("gram_tile cross", c1.calls.get(False))) if args is not None}
    with torch.no_grad():
        bwd = gram_bwd_checks(c6.calls, tag="sparse gram_bwd")
    checks["gram_bwd"] = (bwd["max_abs_err"], "x̄ within 2·√m·eps·Σ|terms|, scalars 1e-4",
                          {m_: r["shape"] for m_, r in bwd["modes"].items()}, bwd["ok"])
    checks = report_checks("sparse", checks)
    ok = ok and all(r["ok"] for r in checks.values())

    times = {}

    def timed(name, fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) / reps * 1e3
        return out

    with torch.no_grad():
        timed("elbo", lambda: collapsed())
    timed("elbo grad", lambda: torch.autograd.grad(collapsed(), leaves))
    with torch.no_grad():
        dv = timed("dtc", lambda: collapsed("dtc"))
        d_err = abs(float(dv) - float(dtc64)) / abs(float(dtc64))
        dtc_ok = d_err <= _tol_rel(kappa)
        print(f"[sparse] DTC objective {float(dv):.4f} (f64 {float(dtc64):.4f}, rel error "
              f"{d_err:.3e}, tol {_tol_rel(kappa):.3e}); {'ok' if dtc_ok else 'FAIL'}",
              flush=True)
        ok = ok and dtc_ok

        s2_, ard_, noise_, z_ = vals
        f = agt.GP(ard_kernel(s2_, ard_))
        vfe = agt.VFE(f(z_, JITTER))
        xt = torch.rand((c["test"], d), generator=gen, device=dev) * 4.0
        reset_launches()
        mu, var = agt.posterior(vfe, f(x, noise_), y).mean_and_var(xt)
        pred_launches = read_launches()
        timed("posterior + mean_and_var",
              lambda: agt.posterior(vfe, f(x, noise_), y).mean_and_var(xt))
        *_, mu64, var64 = vfe_f64(*[v.double() for v in vals], x, y, xt)
        errs_p = {"mean": float((mu.double() - mu64).abs().max() / mu64.abs().max()),
                  "var": float((var.double() - var64).abs().max() / var64.max())}
        pred_ok = (all(v <= _tol_rel(kappa) for v in errs_p.values())
                   and bool(torch.isfinite(mu).all()) and float(var.min()) >= 0.0)
        print(f"[sparse] posterior(VFE).mean_and_var at {c['test']} points against f64: rel "
              f"errors {json.dumps(errs_p)}, tol {_tol_rel(kappa):.3e}; launches "
              f"{json.dumps(pred_launches)}; {'ok' if pred_ok else 'FAIL'}", flush=True)
        ok = ok and pred_ok

        # update_posterior: 2048 new observations, then 64 new pseudo-points,
        # each against the batch posterior (both f32 through the same code;
        # κ of the batch's Λ in f64)
        post = agt.posterior(vfe, f(x, noise_), y)
        x2 = torch.rand((c["new_obs"], d), generator=gen, device=dev) * 4.0
        w = torch.exp(-torch.arange(d, device=dev, dtype=torch.float32) / 2.0)
        y2 = (torch.sin(x2) @ w + 0.3 * torch.cos(2.0 * x2[:, 0])
              + 0.2 * torch.randn(c["new_obs"], generator=gen, device=dev))
        z2 = x[torch.randperm(n, generator=gen, device=dev)[:c["new_z"]]]
        x_all, y_all = torch.cat([x, x2]), torch.cat([y, y2])
        z_all = torch.cat([z_, z2])
        cases = (
            ("new observations", lambda: agt.update_posterior(post, f(x2, noise_), y2),
             lambda: agt.posterior(vfe, f(x_all, noise_), y_all), z_, x_all, y_all),
            ("new pseudo-points", lambda: agt.update_posterior(post, f(z2, JITTER)),
             lambda: agt.posterior(agt.VFE(f(z_all, JITTER)), f(x, noise_), y), z_all, x, y))
        for name, upd, batch, zz, xx, yy in cases:
            p_upd = timed(f"update {name}", upd)
            mu_u, var_u = p_upd.mean_and_var(xt)
            mu_b, var_b = timed(f"batch {name}", batch).mean_and_var(xt)
            _, _, kz, kl = vfe_f64(*[v.double() for v in vals[:3]], zz, xx, yy)
            k = max(kz, kl)
            e_u = {"mean": float((mu_u - mu_b).abs().max() / mu_b.abs().max()),
                   "var": float((var_u - var_b).abs().max() / var_b.max())}
            u_ok = all(v <= _tol_rel(k) for v in e_u.values()) and bool(
                torch.isfinite(mu_u).all())
            print(f"[sparse] update_posterior with {name} ({times[f'update {name}']:.3f} ms) "
                  f"against the batch posterior ({times[f'batch {name}']:.3f} ms): rel errors "
                  f"{json.dumps(e_u)}, kappa {k:.3e}, tol {_tol_rel(k):.3e}; "
                  f"{'ok' if u_ok else 'FAIL'}", flush=True)
            ok = ok and u_ok
    print(f"[sparse] times (ms, host clock, 3 warm calls each): {json.dumps(times)}",
          flush=True)
    profile_breakdown("sparse elbo grad", lambda: torch.autograd.grad(collapsed(), leaves),
                      top=8)
    return ok, {"sparse elbo grad": grad_launches, "sparse pred": pred_launches}, checks


def run_online(seed, dev, fitted):
    """[online]: 16 ``online_extend``s of 512 observations into a cache of
    capacity 8192 under [svgp]'s fitted kernel, ``online_mean_and_var`` at
    4096 points against the port's exact ``posterior(f(x, 0.1), y)``, then
    one extend past the capacity, which must poison with NaN. Returns (ok,
    launches by run, the kernels' checks by name)."""
    import torch

    import abstractgps_tpu_torch as agt
    from abstractgps_tpu_torch.models import online

    c = ONLINE
    cap, b, d, noise = c["cap"], c["b"], SPARSE["d"], c["noise"]
    x, y, gen = sparse_data(seed + 44, dev, cap + b, d)
    xt = torch.rand((c["test"], d), generator=gen, device=dev) * 4.0
    f = agt.GP(ard_kernel(fitted["s2"], fitted["ard"]))
    ok = True
    with torch.no_grad(), \
            capture_first_input("gram_tile", "fused_gram", key=_sym_key) as c1, \
            capture_first_input("tri_inv_block") as c4:
        st = online.online_init(f, cap, d, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        marks = []
        t0 = time.perf_counter()
        for i in range(0, cap, b):
            marks.append(read_launches())
            prev = st
            st = online.online_extend(st, x[i:i + b], y[i:i + b], noise)
        torch.cuda.synchronize()
        t_ext = time.perf_counter() - t0
        marks.append(read_launches())
        ext_launches = marks[-1]
        reset_launches()
        t0 = time.perf_counter()
        mu, var = online.online_mean_and_var(st, xt)
        torch.cuda.synchronize()
        t_pred = time.perf_counter() - t0
        pred_launches = read_launches()
        per_ext = [_diff(marks[i + 1], marks[i]) for i in range(len(marks) - 1)]
        want = {k: ONLINE_EXTEND_LAUNCHES.get(k, 0) for k in per_ext[0]}
        ext_ok = all(e == want for e in per_ext)
        mu_b, var_b = agt.posterior(f(x[:cap], noise), y[:cap]).mean_and_var(xt)
        # κ(K + σ²I) ≤ (λ_max + σ²)/σ², λ_max by power iteration in f64
        K = se_ard_f64(x[:cap], x[:cap], fitted["s2"].double(), fitted["ard"].double())
        v = torch.ones(cap, dtype=torch.float64, device=dev)
        for _ in range(50):
            v = K @ v
            v = v / v.norm()
        kappa = (float(v @ (K @ v)) + noise) * 1.01 / noise
        del K
        errs = {"mean": float((mu - mu_b).abs().max() / mu_b.abs().max()),
                "var": float((var - var_b).abs().max() / var_b.max())}
        match_ok = (all(e <= _tol_rel(kappa) for e in errs.values())
                    and bool(torch.isfinite(mu).all()) and ext_ok)
        print(f"[online] capacity {cap}, {cap // b} extends of {b} in {t_ext * 1e3:.3f} ms "
              f"({t_ext / (cap // b) * 1e3:.3f} ms per extend); online_mean_and_var at "
              f"{c['test']} points {t_pred * 1e3:.3f} ms; against posterior(f(x, {noise}), y) "
              f"at N={cap}: rel errors {json.dumps(errs)}, kappa<= {kappa:.3e}, tol "
              f"{_tol_rel(kappa):.3e}; launches per extend {json.dumps(per_ext[0])} (predicted "
              f"{json.dumps(ONLINE_EXTEND_LAUNCHES)}, every extend as predicted: {ext_ok}); "
              f"prediction launches {json.dumps(pred_launches)}; "
              f"{'ok' if match_ok else 'FAIL'}", flush=True)
        ok = ok and match_ok
        # one extend past the capacity: the write stays inside the buffers
        # (a device assert would kill the process here), the cache is NaN
        st2 = online.online_extend(st, x[cap:], y[cap:], noise)
        mu1, var1 = online.online_mean_and_var(st2, xt)
        torch.cuda.synchronize()
        nan_ok = bool(torch.isnan(mu1).all()) and bool(torch.isnan(var1).all())
        print(f"[online] one extend past the capacity (count {int(st2.count)} > {cap}): every "
              f"mean and variance NaN {nan_ok}; {'ok' if nan_ok else 'FAIL'}", flush=True)
        ok = ok and nan_ok
        checks = {name: forward_kernel_check("gram_tile", args)
                  for name, args in (("gram_tile sym", c1.calls.get(True)),
                                     ("gram_tile cross", c1.calls.get(False)))
                  if args is not None}
        if c4.value is not None:
            checks["tri_inv_block"] = forward_kernel_check("tri_inv_block", c4.calls[None])
        checks = report_checks("online", checks)
        ok = ok and all(r["ok"] for r in checks.values())
        # the last extend again (into a cache holding 7680 rows)
        profile_breakdown("online extend", lambda: online.online_extend(
            prev, x[cap - b:cap], y[cap - b:cap], noise), top=8)
    return ok, {"online extends": ext_launches, "online pred": pred_launches}, checks


# ---------------------------------------------------------------------------
# The matrix-free CG backend at N = 32 768 and pathwise sampling at full width
# ---------------------------------------------------------------------------

# [cg]: N = 32 768 (four times the exact path's width, past max_dense_n =
# 8192: a matvec is one fused gram_matvec, the backward rebuilds 32 panels of
# 1024 rows), D = 8, σ²·Matérn-3/2 with
# ℓ, σ² = ℓ = 1, noise 0.1, f32, ``CGInference()``'s defaults (32 probes,
# 256 steps, rank-64 preconditioner, probe seed 0); the posterior mean at
# 4096 points and ``mean_and_var`` at 256; the ∇'s spread over 4 probe seeds
CG = dict(n=32768, d=8, m_mean=4096, m_var=256, noise=0.1, seeds=4)
CG_KERNELS = ("gram_tile", "gram_bwd", "gram_matvec")
# [pathwise]: the exact posterior of the [e2e] data (N = 8192, D = 8), 1024
# random features, 1024 paths, evaluated at the 4096 test points
PATHWISE = dict(n=8192, m=4096, d=8, features=1024, samples=1024)
PATHWISE_KERNELS = ("gram_tile", "slab_factor", "tri_inv_block")


class record_calls:
    """Record ``(args, result)`` of every call of ``module.name`` during a
    run (the function still runs): what a run computed, for its checks."""

    def __init__(self, module, name):
        self.mod, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def spy(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            self.calls.append((args, out))
            return out

        setattr(self.mod, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def host_ms(fn, reps: int = 3) -> list:
    """Host-clock ms of ``reps`` calls of ``fn``, each ending in a
    synchronize (the first, counted run of a path was its warm-up)."""
    import torch

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def cg_data(seed, dev):
    """x ~ U[0,1]^8 and y ~ N(0, 1) from ``seed`` with numpy (the order of
    bench.py:64-66), then the 4096 test points; f32 on the card."""
    import numpy as np
    import torch

    c = CG
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(c["n"], c["d"]))
    y = rng.normal(size=c["n"])
    xs = rng.uniform(size=(c["m_mean"], c["d"]))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (x, y, xs)]


def matern32_f64(a, b, s2=1.0, ell=1.0, block=2048):
    """σ²·Matérn-3/2 between the rows of a and b in f64 from ``torch.cdist``,
    built in row blocks, written apart from the port."""
    import torch

    a, b = a.double(), b.double()
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float64, device=a.device)
    for r0 in range(0, a.shape[0], block):
        t = math.sqrt(3.0) / ell * torch.cdist(a[r0:r0 + block], b)
        out[r0:r0 + block] = s2 * (1.0 + t) * torch.exp(-t)
    return out


def cg_oracle_f64(x, y, xs, xs_v, alphas, W, s2=1.0, ell=1.0, noise=0.1):
    """Dense f64 reference of [cg] on the card, written apart from the port.
    ``alphas`` (name → α) and ``W`` (the CG solve of ``mean_and_var``
    against K(x, xs_v)) are the port's f32 iterates: their true residuals.
    Returns a dict: relative residuals of each α and of W's columns, the
    logdet and logpdf, α*, the posterior mean at xs and variance at xs_v,
    the rounding scales of both, κ, and ∇logpdf in (σ², ℓ, noise) from
    ½(αᵀ ∂K α − tr(A⁻¹ ∂K)), the trace against A⁻¹ = cholesky_inverse."""
    import torch

    n = x.shape[0]
    y64 = y.double()
    out = {}
    with torch.no_grad():
        A = matern32_f64(x, x, s2, ell)
        A.diagonal().add_(noise)
        v = torch.ones(n, dtype=torch.float64, device=x.device)
        for _ in range(50):
            v = A @ v
            v = v / v.norm()
        out["kappa"] = float(v @ (A @ v)) * 1.01 / noise
        out["res"] = {k: float((A @ a.double() - y64).norm() / y64.norm())
                      for k, a in alphas.items()}
        out["res_abs_post"] = float((A @ alphas["posterior"].double() - y64).norm())
        Kv = matern32_f64(x, xs_v, s2, ell)
        Rw = A @ W.double() - Kv
        out["res_w"], out["res_w_abs"] = Rw.norm(dim=0) / Kv.norm(dim=0), Rw.norm(dim=0)
        del Rw
        L = torch.linalg.cholesky(A)
        del A
        out["logdet"] = float(2.0 * torch.log(torch.diagonal(L)).sum())
        alpha = torch.cholesky_solve(y64[:, None], L)[:, 0]
        out["lp"] = -0.5 * (n * math.log(2 * math.pi) + out["logdet"] + float(y64 @ alpha))
        Km = matern32_f64(x, xs, s2, ell)
        out["mu"] = Km.T @ alpha
        out["mu_scale"] = Km.abs().T @ alpha.abs()  # Σ_j |k_ij α*_j|
        del Km
        Wv = torch.cholesky_solve(Kv, L)
        out["var"] = s2 - (Kv * Wv).sum(0)
        out["var_scale"] = (Kv * Wv).abs().sum(0)
        del Wv, Kv
        Ainv = torch.cholesky_inverse(L)
        del L
        q = torch.zeros(2, dtype=torch.float64, device=x.device)
        tr = torch.zeros_like(q)
        x64 = x.double()
        for r0 in range(0, n, 2048):
            t = math.sqrt(3.0) / ell * torch.cdist(x64[r0:r0 + 2048], x64)
            e = torch.exp(-t)
            for i, dK in enumerate(((1.0 + t) * e, s2 * t * t * e / ell)):  # ∂/∂σ², ∂/∂ℓ
                q[i] += alpha[r0:r0 + 2048] @ (dK @ alpha)
                tr[i] += (Ainv[r0:r0 + 2048] * dK).sum()
        g_noise = 0.5 * (alpha @ alpha - torch.diagonal(Ainv).sum())
        out["grad"] = torch.stack([0.5 * (q[0] - tr[0]), 0.5 * (q[1] - tr[1]), g_noise]).cpu()
        del Ainv
    return out


def run_cg(seed, dev):
    """[cg]: ``approx_log_evidence(CGInference(), fx, y)``, its
    ``torch.autograd.grad`` with respect to (σ², ℓ, noise) (caller tensors),
    ``CGInference().posterior(fx, y)``, ``mean`` at 4096 points and
    ``mean_and_var`` at 256, at the configuration ``CG``; each counted, then
    timed over one warm call (three of ``mean``); the ∇ again at probe seeds
    1-3 for its spread; the logpdf again with ``fused_gram.set_enabled(False)``; the kernels
    against their plain versions on the path's own inputs; checks (a)-(d)
    against ``cg_oracle_f64``. Returns (ok, launches by run, the kernels'
    checks by name)."""
    import torch

    import abstractgps_tpu_torch as agt
    from abstractgps_tpu_torch.models import iterative
    from abstractgps_tpu_torch.ops import fused_gram

    c = CG
    n, noise = c["n"], c["noise"]
    x, y, xs = cg_data(seed + 50, dev)
    xs_v = xs[:c["m_var"]]
    theta = caller_theta(1.0, 1.0, dev, torch.float32)  # σ², ℓ, the noise (NOISE = 0.1)
    inf = agt.CGInference()
    tol = torch.finfo(torch.float32).eps ** 0.5  # mbcg's default

    def fx_of(th):
        s2, ell, nz = th
        return agt.GP(s2 * agt.with_lengthscale(agt.Matern32Kernel(), ell))(x, nz)

    def logpdf():
        with torch.no_grad():
            return agt.approx_log_evidence(inf, fx_of([t.detach() for t in theta]), y)

    def grad(probe_seed=0):
        lp = agt.approx_log_evidence(agt.CGInference(probe_seed=probe_seed), fx_of(theta), y)
        return torch.stack(torch.autograd.grad(lp, theta)).double().cpu()

    def steps(actives):
        a = actives.sum(0).cpu()
        return [int(v) for v in a]

    runs, ok = {}, True
    # the logpdf: its mbcg (α, the coefficients) and slq_logdet arguments kept
    with record_calls(iterative, "mbcg") as mb, record_calls(iterative, "slq_logdet") as sq, \
            capture_first_input("gram_matvec_fused", "matvec") as cm:
        torch.cuda.synchronize()
        reset_launches()
        lp = logpdf()
        torch.cuda.synchronize()
        runs["cg logpdf"] = read_launches()
    (_, B), (X, (alphas_c, betas_c, actives_c)) = mb.calls[0]
    alpha_lp = X[:, 0].clone()
    slq_args = sq.calls[0][0]
    lp_steps = steps(actives_c)
    del mb, X
    # the ∇, its peak memory above what was allocated before it
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with capture_first_input("gram_bwd", "fused_gram", key=lambda a: a[6]) as c6, \
            capture_first_input("gram_tile", "fused_gram") as c1:
        reset_launches()
        g0 = grad()
        torch.cuda.synchronize()
        runs["cg grad"] = read_launches()
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    # the posterior, its mean and mean_and_var (W of the last kept)
    with torch.no_grad():
        reset_launches()
        with record_calls(iterative, "mbcg") as mb:
            post = agt.posterior(inf, fx_of([t.detach() for t in theta]), y)
            torch.cuda.synchronize()
        runs["cg posterior"] = read_launches()
        post_steps = steps(mb.calls[0][1][1][2])
        reset_launches()
        mu = post.mean(xs)
        torch.cuda.synchronize()
        runs["cg mean"] = read_launches()
        reset_launches()
        with record_calls(iterative, "mbcg") as mb:
            mu_v, var_v = post.mean_and_var(xs_v)
            torch.cuda.synchronize()
        runs["cg mean_and_var"] = read_launches()
        W = mb.calls[0][1][0]
        mv_steps = steps(mb.calls[0][1][1][2])
        del mb
    # one warm call of each seconds-long call (the script's time limit), 3 of mean
    times = {
        "logpdf": host_ms(logpdf, 1),
        "grad": host_ms(grad, 1),
        "posterior": host_ms(lambda: agt.posterior(inf, fx_of([t.detach() for t in theta]), y),
                             1),
        "mean": host_ms(lambda: post.mean(xs)),
        "mean_and_var": host_ms(lambda: post.mean_and_var(xs_v), 1),
    }
    probe_steps = lp_steps[1:]
    route = "one fused gram_matvec" if n > inf.max_dense_n else "one dense GEMM"
    print(f"[cg] N={n} D={c['d']} f32, CGInference() (32 probes, 256 steps, rank-64 "
          f"preconditioner), {route} a matvec: logpdf {float(lp):.4f}; host ms of warm "
          f"calls (each ending in a synchronize): "
          + "; ".join(f"{k} {', '.join(f'{v:.3f}' for v in t)}" for k, t in times.items())
          + f"; peak memory of the ∇ above its inputs {peak_gib:.3f} GiB", flush=True)
    print(f"[cg] steps each column stayed active (of 256): logpdf data column {lp_steps[0]}, "
          f"probes min {min(probe_steps)} median {sorted(probe_steps)[len(probe_steps) // 2]} max "
          f"{max(probe_steps)}; posterior {post_steps[0]}; mean_and_var's 256 columns min "
          f"{min(mv_steps)} median {sorted(mv_steps)[len(mv_steps) // 2]} max {max(mv_steps)}",
          flush=True)
    print(f"[cg] launches: {json.dumps(runs)}", flush=True)
    # the ∇ at three more probe seeds: the Hutchinson spread of one estimate
    gs = torch.stack([g0] + [grad(s) for s in range(1, c["seeds"])])
    # the logpdf with the fused gram switched off (the library path)
    fused_gram.set_enabled(False)
    try:
        with record_calls(iterative, "mbcg") as mb, \
                record_calls(iterative, "slq_logdet") as sq_off:
            reset_launches()
            lp_off = logpdf()
            torch.cuda.synchronize()
            runs["cg logpdf set_enabled(False)"] = read_launches()
        alpha_off = mb.calls[0][1][0][:, 0].clone()
        off_steps = steps(mb.calls[0][1][1][2])
        slq_off = sq_off.calls[0][0]
        del mb
    finally:
        fused_gram.set_enabled(True)

    # ---- checks against the dense f64 oracle ----------------------------
    ref = cg_oracle_f64(x, y, xs, xs_v, {"logpdf": alpha_lp, "posterior": post.alpha,
                                         "logpdf set_enabled(False)": alpha_off}, W, noise=noise)
    torch.cuda.empty_cache()
    y64 = y.double()

    def slq_check(tag, lp_, alpha_, args):
        # logdet = −2·lp − n·log 2π − δᵀα; per probe, logdet P + its SLQ term
        a_, b_, act_, nrm = args
        per = torch.stack([iterative.slq_logdet(a_[:, j:j + 1], b_[:, j:j + 1],
                                                act_[:, j:j + 1], nrm[j:j + 1])
                           for j in range(nrm.shape[0])]).double()
        logdet = -2.0 * float(lp_) - n * math.log(2 * math.pi) - float(y64 @ alpha_.double())
        per = per - per.mean() + logdet
        se = float(per.std() / math.sqrt(per.shape[0]))
        err = abs(logdet - ref["logdet"])
        res = ref["res"][tag]
        good = res <= 4 * tol and err <= 4 * se
        print(f"[cg {tag}] (a) true f64 relative residual of α {res:.3e} (tol 4·tol = "
              f"{4 * tol:.3e}); (b) SLQ logdet {logdet:.4f} vs f64 {ref['logdet']:.4f}: error "
              f"{err:.4f}, {err / se:.3f} standard errors (SE {se:.4f} from the {per.shape[0]} "
              f"per-probe values; limit 4); logpdf {float(lp_):.4f} vs f64 {ref['lp']:.4f}; "
              f"{'ok' if good else 'FAIL'}", flush=True)
        return good, logdet

    ok_a, logdet_on = slq_check("logpdf", lp, alpha_lp, slq_args)
    ok_off, logdet_off = slq_check("logpdf set_enabled(False)", lp_off, alpha_off, slq_off)
    off_launched = {k: v for k, v in runs["cg logpdf set_enabled(False)"].items() if v}
    print(f"[cg set_enabled(False)] fused off minus on: logpdf {float(lp_off) - float(lp):.4e}, "
          f"logdet {logdet_off - logdet_on:.4e}, data column active steps {off_steps[0]} vs "
          f"{lp_steps[0]}; kernels launched {off_launched}", flush=True)
    ok_off = ok_off and not off_launched
    # (c) the ∇ against f64, in the spread of one estimate over 4 probe seeds
    g64 = ref["grad"]
    sd = gs.std(dim=0)
    err_g = (g0 - g64).abs()
    err_mean = (gs.mean(0) - g64).abs()
    ok_c = bool(torch.isfinite(gs).all()) and bool((err_g <= 4.0 * sd).all())
    print(f"[cg grad] (c) ∇ (s2, ell, noise) seed 0 {[round(v, 4) for v in g0.tolist()]}, f64 "
          f"{[round(v, 4) for v in g64.tolist()]}; spread of one estimate over 4 probe seeds "
          f"{[round(v, 4) for v in sd.tolist()]}; seed-0 error / spread "
          f"{[round(v, 3) for v in (err_g / sd).tolist()]} (limit 4); error of the 4-seed mean / "
          f"its standard error {[round(v, 3) for v in (err_mean / (sd / 2.0)).tolist()]}; "
          f"seed-0 error / the JAX package's 0.05·max(1, |g|) "
          f"{[round(v, 3) for v in (err_g / (0.05 * g64.abs().clamp_min(1.0))).tolist()]}; "
          f"{'ok' if ok_c else 'FAIL'}", flush=True)
    # (d) the posterior: CG's A-norm bound |k*ᵀ(α − α*)| ≤ ‖A^{-1/2}k*‖·‖r‖/√λ_min
    # with ‖A^{-1/2}k*‖ ≤ σ = 1, λ_min ≥ the noise and r the measured true
    # residual (of α for the mean, of W's column for each variance), plus
    # f32 rounding of the N-term sums at 8·√N·eps·Σ|terms| (the dot
    # product's and its gram entries' rounding, probabilistic bound)
    rnd = 8.0 * math.sqrt(n) * EPS32
    tol_mu = ref["res_abs_post"] / math.sqrt(noise) + rnd * ref["mu_scale"]
    tol_var = ref["res_w_abs"] / math.sqrt(noise) + rnd * ref["var_scale"]
    e_mu = (mu.double() - ref["mu"]).abs()
    e_mu_v = (mu_v.double() - ref["mu"][:c["m_var"]]).abs()
    e_var = (var_v.double() - ref["var"]).abs()
    ok_d = (bool(torch.isfinite(mu).all()) and bool(torch.isfinite(var_v).all())
            and bool((e_mu <= tol_mu).all()) and bool((e_var <= tol_var).all())
            and bool((e_mu_v <= tol_mu[:c["m_var"]]).all())
            and mu.shape == (c["m_mean"],) and var_v.shape == (c["m_var"],))
    print(f"[cg posterior] (a) true f64 relative residual of α {ref['res']['posterior']:.3e}, of "
          f"mean_and_var's 256 columns max {float(ref['res_w'].max()):.3e} (tol 4·tol = "
          f"{4 * tol:.3e}); (d) mean at {c['m_mean']} points: max error {float(e_mu.max()):.3e}, "
          f"largest error / tolerance {float((e_mu / tol_mu).max()):.3e} (tolerance median "
          f"{float(tol_mu.median()):.3e}, max|mean| {float(ref['mu'].abs().max()):.3e}); variance "
          f"at {c['m_var']}: max error {float(e_var.max()):.3e}, largest error / tolerance "
          f"{float((e_var / tol_var).max()):.3e} (tolerance median {float(tol_var.median()):.3e}, "
          f"var range {float(ref['var'].min()):.3e}..{float(ref['var'].max()):.3e}); kappa<= "
          f"{ref['kappa']:.3e}; {'ok' if ok_d else 'FAIL'}", flush=True)
    ok_res = ref["res"]["posterior"] <= 4 * tol and float(ref["res_w"].max()) <= 4 * tol
    ok = ok and ok_a and ok_off and ok_c and ok_d and ok_res
    # the kernels on the path's own inputs
    pargs = c1.calls[None]
    checks = report_checks("cg", {"gram_tile cg panel": forward_kernel_check("gram_tile", pargs)})
    checks["gram_matvec cg"] = gram_matvec_check(cm.calls[None])
    bwd = gram_bwd_checks(c6.calls, tag="cg gram_bwd")
    for mode, r in bwd["modes"].items():
        checks[f"gram_bwd {mode}"] = dict(max_abs_err=r["max_abs_err"], shape=r["shape"],
                                          ok=r["ok"], device_ms=r["device_ms"],
                                          bound_ms=r["bound_ms"])
    checks["gram_tile cg panel"].update(gram_tile_timing("cg panel", pargs))
    ok = ok and all(r["ok"] for r in checks.values())
    profile_breakdown("cg logpdf", logpdf, top=8)
    profile_breakdown("cg grad", grad, top=8)
    return ok, runs, checks


def run_pathwise(seed, dev):
    """[pathwise]: ``pathwise_sample(posterior(f(x, 0.1), y), seed,
    num_features=1024, num_samples=1024)`` at the [e2e] data (N = 8192,
    D = 8, f32), its 1024 paths evaluated at the 4096 test points; setup
    (the exact posterior, the features, the wide solve) and evaluation each
    counted, then timed over 3 warm calls; the paths' moments at each point
    against the f64 posterior; the kernels against their plain versions on
    the path's inputs. Returns (ok, launches by run, the kernels' checks)."""
    import torch

    import abstractgps_tpu_torch as agt
    from abstractgps_tpu_torch.models import pathwise

    c = PATHWISE
    n, m, s = c["n"], c["m"], c["samples"]
    x, y, xs, s2, ell = make_problem(seed, n, m, c["d"], dev, torch.float32)
    kernel = make_kernel(s2, ell, dev, torch.float32)
    runs = {}

    def setup():
        post = agt.posterior(agt.GP(kernel)(x, NOISE), y)
        return agt.pathwise_sample(post, seed, num_features=c["features"], num_samples=s)

    with torch.no_grad():
        with capture_first_input("tri_inv_block") as c4, \
                capture_first_input("gram_tile", "fused_gram",
                                    key=lambda a: (a[0].shape[0], a[1].shape[0])) as c1, \
                record_calls(pathwise, "sample_fourier_features") as sf:
            torch.cuda.synchronize()
            reset_launches()
            g = setup()
            torch.cuda.synchronize()
            runs["pathwise setup"] = read_launches()
            reset_launches()
            S = g(xs)
            torch.cuda.synchronize()
            runs["pathwise eval"] = read_launches()
        phi = sf.calls[0][1]
        t_setup = host_ms(setup)
        t_eval = host_ms(lambda: g(xs))
    print(f"[pathwise] N={n} D={c['d']} f32, {c['features']} features, {s} paths at {m} points: "
          f"setup ms {', '.join(f'{v:.3f}' for v in t_setup)}; evaluation ms "
          f"{', '.join(f'{v:.3f}' for v in t_eval)}; launches {json.dumps(runs)}", flush=True)
    # ---- the paths' moments against the f64 posterior -------------------
    with torch.no_grad():
        x64 = x.double()
        A = matern32_f64(x, x, s2, ell)
        A.diagonal().add_(NOISE)
        v_ = torch.ones(n, dtype=torch.float64, device=dev)
        for _ in range(50):
            v_ = A @ v_
            v_ = v_ / v_.norm()
        kappa = float(v_ @ (A @ v_)) * 1.01 / NOISE
        L = torch.linalg.cholesky(A)
        del A
        Ks = matern32_f64(x, xs, s2, ell)
        alpha = torch.cholesky_solve(y.double()[:, None], L)[:, 0]
        Aks = torch.cholesky_solve(Ks, L)  # A⁻¹K(X, x*)
        mu64 = Ks.T @ alpha
        var64 = s2 - (Ks * Aks).sum(0)
        del Ks, L

        def feats(z):
            # the port's features in f64 from their arrays: the kernel's one
            # input transform is z/ℓ
            return torch.cos((z.double() / ell) @ phi.omega.double().T
                             + phi.bias.double()) * phi.weights.double()

        # RFF truncation: the paths' variance given these features is
        # Σ_j U_ij² + noise·‖A⁻¹k*‖², U = φ(x*) − (A⁻¹K(X, x*))ᵀφ(X); its
        # standard error over the m features, std_j(m·U_ij²)/√m
        U = feats(xs) - Aks.T @ feats(x64)
        m_f = U.shape[1]
        se_rff = (m_f * U * U).std(dim=1) / math.sqrt(m_f)
        del U, Aks
        S64 = S.double()
        mean_s, var_s = S64.mean(1), S64.var(1)
        f32 = 10.0 * kappa * EPS32
        tol_mean = 5.0 * torch.sqrt(var_s / s) + f32 * float(mu64.abs().max())
        tol_var = (5.0 * math.sqrt(2.0 / (s - 1)) * var64 + 5.0 * se_rff
                   + 2.0 * f32 * float(S64.abs().max()) * torch.sqrt(var64))
        e_mean, e_var = (mean_s - mu64).abs(), (var_s - var64).abs()
    ok = (S.shape == (m, s) and bool(torch.isfinite(S).all())
          and bool((e_mean <= tol_mean).all()) and bool((e_var <= tol_var).all()))
    print(f"[pathwise] moments of the {s} paths at {m} points vs the f64 posterior: mean max "
          f"error {float(e_mean.max()):.3e}, largest error / tolerance "
          f"{float((e_mean / tol_mean).max()):.3e} (5 standard errors of the sample mean + "
          f"10·kappa·eps·max|mean|); variance max error {float(e_var.max()):.3e}, largest error / "
          f"tolerance {float((e_var / tol_var).max()):.3e} (5·sqrt(2/(s-1))·var + 5 RFF standard "
          f"errors, median {float(se_rff.median()):.3e}, + f32 2·10·kappa·eps·max|path|·sd); var "
          f"range {float(var64.min()):.3e}..{float(var64.max()):.3e}; kappa<= {kappa:.3e}; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    checks = {"gram_tile cross": forward_kernel_check("gram_tile", c1.calls[(m, n)],
                                                      gram_tol=3e-5),
              "tri_inv_block": forward_kernel_check("tri_inv_block", c4.calls[None])}
    checks = report_checks("pathwise", checks)
    ok = ok and all(r["ok"] for r in checks.values())
    with torch.no_grad():
        profile_breakdown("pathwise setup", setup, top=8)
        profile_breakdown("pathwise eval", lambda: g(xs), top=6)
    return ok, runs, checks


# ---------------------------------------------------------------------------
# The Markov (state-space) backend: the JAX package's own Markov benchmark at
# N = 10^6, then its on-chip cross-check at N = 8192 against the dense path
# ---------------------------------------------------------------------------

# bench.py:319-349 (N = 10^6, t = sort(U(0, 1000)), σ² = 1, Matérn-3/2, ℓ = 0.5,
# noise 0.1, f32) and examples/validate_tpu.py:92-113 (N = 8192 over U(0, 50)):
# test points of the marginals, of the joint posterior and of its cross block
MARKOV = dict(n=1_000_000, t_max=1000.0, s2=1.0, ell=0.5, noise=0.1, n_val=8192,
              t_val=50.0, m_val=1024, m_joint=64, m_cross=32, samples=256)
# the dense comparators' runs at N = 8192, D = 1, and the kernels each must launch
MARKOV_DENSE_KERNELS = {"markov dense logpdf": ("gram_tile", "slab_factor"),
                        "markov dense grad": ("gram_tile", "slab_factor", "tri_inv_block",
                                              "logpdf_contraction"),
                        "markov dense pred": ("gram_tile", "slab_factor", "tri_inv_block")}
MARKOV_F32 = 1e-3  # the JAX package's f32 contract for one Matérn component (relative)
MARKOV_VS_DENSE = 5e-3  # examples/validate_tpu.py:112-113
# central differences of the numpy f64 filter at h = 1e-4·θ: their truncation,
# (h/θ)²·θ²|f⁽³⁾|/(6|f′|), is ~1e-8 for a log-likelihood whose k-th derivative
# scales as N/θᵏ, and the fsum'd filter's rounding moves a difference by ≲ 1e-9
# relative; 1e-5 leaves room
MARKOV_FD = 1e-5


def markov_filter_f64(t, y, s2, ell, noise):
    """log p(y) of σ²·Matérn-3/2 (ℓ) plus noise at sorted times ``t``: a
    sequential Kalman filter on the host in f64, unrolled to scalars and
    written apart from the port. A = e^{−λdt}[[1 + λdt, dt], [−λ²dt,
    1 − λdt]], λ = √3/ℓ, Q = P∞ − A P∞ Aᵀ, P∞ = diag(σ², λ²σ²) (at dt = 0:
    A = I, Q = 0); the log terms summed by ``math.fsum``."""
    import numpy as np

    lam = math.sqrt(3.0) / ell
    dt = np.diff(np.asarray(t, dtype=np.float64))
    e = np.exp(-lam * dt)
    a00, a01, a10, a11 = e * (1.0 + lam * dt), e * dt, -e * lam * lam * dt, e * (1.0 - lam * dt)
    p0, p1 = s2, s2 * lam * lam
    q00 = p0 - (a00 * a00 * p0 + a01 * a01 * p1)
    q01 = -(a00 * a10 * p0 + a01 * a11 * p1)
    q11 = p1 - (a10 * a10 * p0 + a11 * a11 * p1)
    ys = np.asarray(y, dtype=np.float64).tolist()
    m0 = m1 = P01 = 0.0
    P00, P11 = p0, p1  # the prediction of step 0: the stationary prior
    terms = []
    log = math.log
    steps = zip(ys[1:], a00.tolist(), a01.tolist(), a10.tolist(), a11.tolist(),
                q00.tolist(), q01.tolist(), q11.tolist())
    yk = ys[0]
    while True:
        S = P00 + noise
        v = yk - m0
        terms.append(log(S) + v * v / S)
        k0, k1 = P00 / S, P01 / S
        m0, m1 = m0 + k0 * v, m1 + k1 * v
        P00, P01, P11 = P00 - k0 * P00, P01 - k0 * P01, P11 - k1 * P01
        nxt = next(steps, None)
        if nxt is None:
            break
        yk, b00, b01, b10, b11, r00, r01, r11 = nxt
        m0, m1 = b00 * m0 + b01 * m1, b10 * m0 + b11 * m1
        t00, t01 = b00 * P00 + b01 * P01, b00 * P01 + b01 * P11
        t10, t11 = b10 * P00 + b11 * P01, b10 * P01 + b11 * P11
        P00, P01, P11 = (t00 * b00 + t01 * b01 + r00, t00 * b10 + t01 * b11 + r01,
                         t10 * b10 + t11 * b11 + r11)
    return -0.5 * (len(ys) * math.log(2.0 * math.pi) + math.fsum(terms))


def markov_theta(dtype, dev, c):
    """σ², ℓ and the noise of ``c`` as caller tensors that require grad."""
    import torch

    return [torch.tensor(c[k], dtype=dtype, device=dev, requires_grad=True)
            for k in ("s2", "ell", "noise")]


def markov_fx(theta, t):
    import abstractgps_tpu_torch as agt

    s2, ell, noise = theta
    return agt.GP(s2 * agt.with_lengthscale(agt.Matern32Kernel(), ell))(t, noise)


def markov_value_and_grad(theta, t, y, fn):
    """``fn(fx, y)`` at caller tensors θ and its ∇ in θ (f64 on the host)."""
    import torch

    lp = fn(markov_fx(theta, t), y)
    g = torch.autograd.grad(lp, theta)
    return float(lp.detach()), torch.stack(g).double().cpu()


def _rel(got, want):
    """|got − want| / |want|: a float, or a list a component for tensors."""
    import torch

    if isinstance(got, torch.Tensor):
        return ((got - want).abs() / want.abs()).tolist()
    return abs(got - want) / abs(want)


def run_markov(seed, dev):
    """[markov]: ``markov_logpdf(fx, y, parallel=True)`` and its ∇ in caller
    (σ², ℓ, noise) at the JAX package's Markov benchmark (N = 10⁶, f32), each
    counted (no port kernel may launch), timed over 3 warm calls and traced;
    the ∇'s peak memory; (a) the logpdf against the numpy f64 filter, (b) the
    ∇ against the port's f64 parallel ∇ and central differences of the numpy
    filter, all on the same f32 inputs widened to f64. Then
    ``run_markov_val``. Returns (ok, launches by run, the kernels' checks)."""
    import numpy as np
    import torch

    from abstractgps_tpu_torch.models import markov

    c = MARKOV
    f32, f64 = torch.float32, torch.float64
    runs = {}
    rng = np.random.default_rng(seed)
    t = torch.as_tensor(np.sort(rng.uniform(0.0, c["t_max"], size=c["n"])), dtype=f32,
                        device=dev)
    y = torch.as_tensor(rng.normal(size=c["n"]), dtype=f32, device=dev)
    zero_steps = int((t[1:] == t[:-1]).sum())
    print(f"[markov] N={c['n']} t ~ sort(U(0, {c['t_max']:g})) in f32: {zero_steps} zero "
          f"steps (repeated timepoints, dt = 0)", flush=True)

    def par_logpdf(fx, yy):
        return markov.markov_logpdf(fx, yy, parallel=True)

    # ---- the parallel logpdf and its ∇ at N = 10^6 -------------------------
    fx_plain = markov_fx([c["s2"], c["ell"], c["noise"]], t)
    theta = markov_theta(f32, dev, c)
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launches()
        lp = float(par_logpdf(fx_plain, y))
        torch.cuda.synchronize()
        runs["markov logpdf"] = read_launches()
        t_lp = host_ms(lambda: par_logpdf(fx_plain, y))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _, g32 = markov_value_and_grad(theta, t, y, par_logpdf)
    torch.cuda.synchronize()
    runs["markov grad"] = read_launches()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    t_g = host_ms(lambda: markov_value_and_grad(theta, t, y, par_logpdf))
    launched = {r: {k: v for k, v in runs[r].items() if v} for r in runs}
    ok_launch = not any(launched.values())
    print(f"[markov] parallel logpdf {lp:.6f}: ms {', '.join(f'{v:.3f}' for v in t_lp)}; ∇ "
          f"(s2, ell, noise) {g32.tolist()}: ms {', '.join(f'{v:.3f}' for v in t_g)}; the ∇'s "
          f"peak {peak:.3f} GiB above its inputs; port kernels launched {json.dumps(launched)} "
          f"({'none, ok' if ok_launch else 'FAIL'}); parallel=False is not run at this N (a "
          f"Python loop of ~25 launches a step: minutes)", flush=True)
    profile_breakdown("markov logpdf", lambda: par_logpdf(fx_plain, y), top=8)
    profile_breakdown("markov grad", lambda: markov_value_and_grad(theta, t, y, par_logpdf),
                      top=8)

    # ---- (a) the logpdf against the numpy f64 filter on the same f32 inputs
    t_np, y_np = t.double().cpu().numpy(), y.double().cpu().numpy()
    t0 = time.perf_counter()
    lp_np = markov_filter_f64(t_np, y_np, c["s2"], c["ell"], c["noise"])
    np_s = time.perf_counter() - t0
    lp64, g64 = markov_value_and_grad(markov_theta(f64, dev, c), t.double(), y.double(),
                                      par_logpdf)
    err_a, err_a64 = _rel(lp, lp_np), _rel(lp64, lp_np)
    ok_a = math.isfinite(lp) and err_a <= MARKOV_F32 and err_a64 <= 1e-9
    print(f"[markov] (a) logpdf f32 {lp:.6f} vs the numpy f64 filter {lp_np:.6f} ({np_s:.1f} s "
          f"on the host): rel error {err_a:.3e} (bound {MARKOV_F32:g}, the JAX package's f32 "
          f"contract); the port at f64 {lp64:.9f}: rel {err_a64:.3e} (bound 1e-9); "
          f"{'ok' if ok_a else 'FAIL'}",
          flush=True)

    # ---- (b) the ∇: finite, against the port's f64 ∇ and central differences
    fd = []
    for k in ("s2", "ell", "noise"):
        h = 1e-4 * c[k]
        hi, lo = dict(c, **{k: c[k] + h}), dict(c, **{k: c[k] - h})
        fd.append((markov_filter_f64(t_np, y_np, hi["s2"], hi["ell"], hi["noise"])
                   - markov_filter_f64(t_np, y_np, lo["s2"], lo["ell"], lo["noise"])) / (2 * h))
    fd = torch.tensor(fd, dtype=f64)
    r32, r64_fd = _rel(g32, g64), _rel(g64, fd)
    finite = bool(torch.isfinite(g32).all()) and bool(torch.isfinite(g64).all())
    ok_b = finite and max(r32) <= MARKOV_F32 and max(r64_fd) <= MARKOV_FD
    print(f"[markov] (b) ∇ (s2, ell, noise) f32 {g32.tolist()}; f64 {g64.tolist()}; central "
          f"differences of the numpy f64 filter {fd.tolist()}; finite {finite} (ell's "
          f"component despite {zero_steps} zero steps); f32 vs f64 rel {r32} (bound "
          f"{MARKOV_F32:g} a component); f64 vs differences rel {r64_fd} (bound {MARKOV_FD:g}); "
          f"{'ok' if ok_b else 'FAIL'}", flush=True)
    del t, y, fx_plain, theta
    torch.cuda.empty_cache()
    val_ok, val_runs, checks = run_markov_val(seed, dev)
    runs.update(val_runs)
    return ok_launch and ok_a and ok_b and val_ok, runs, checks


def markov_dense_f64(t, y, xm, xj, xc, c):
    """The dense f64 posterior on the card, written apart from the port:
    σ²·Matérn-3/2 from |t_i − t_j| (``matern32_f64``), ``torch.linalg``: the
    logpdf, κ(K + noise·I) by power iteration, the mean and variance at
    ``xm``, the mean and covariance at ``xj`` and the cross covariance
    between ``xj`` and ``xc``."""
    import torch

    s2, ell, noise = c["s2"], c["ell"], c["noise"]
    t64, y64 = t.double()[:, None], y.double()
    n = t64.shape[0]
    K = matern32_f64(t64, t64, s2, ell)
    K.diagonal().add_(noise)
    v = torch.ones(n, dtype=torch.float64, device=t.device)
    for _ in range(50):
        v = K @ v
        v = v / v.norm()
    kappa = float(v @ (K @ v)) * 1.01 / noise
    L = torch.linalg.cholesky(K)
    del K
    z = torch.linalg.solve_triangular(L, y64[:, None], upper=False)
    lp = -0.5 * (n * math.log(2 * math.pi) + 2 * torch.log(torch.diagonal(L)).sum()
                 + (z * z).sum())
    alpha = torch.cholesky_solve(y64[:, None], L)[:, 0]

    def post(a, b):
        a64, b64 = a.double()[:, None], b.double()[:, None]
        Ka, Kb = matern32_f64(t64, a64, s2, ell), matern32_f64(t64, b64, s2, ell)
        Va = torch.linalg.solve_triangular(L, Ka, upper=False)
        Vb = torch.linalg.solve_triangular(L, Kb, upper=False)
        return Ka.T @ alpha, matern32_f64(a64, b64, s2, ell) - Va.T @ Vb

    mu_m, C_m = post(xm, xm)
    mu_j, C_j = post(xj, xj)
    _, C_jc = post(xj, xc)
    return dict(lp=float(lp), kappa=kappa, mean=mu_m, var=torch.diagonal(C_m).clone(),
                mean_j=mu_j, cov_j=C_j, cov_jc=C_jc)


def run_markov_val(seed, dev):
    """[markov val], the JAX package's on-chip cross-check
    (examples/validate_tpu.py:92-113) at N = 8192 over U(0, 50), f32: the
    dense fused logpdf, ∇ and ``mean_and_var`` (kernels 1, 2, 4, 5 at D = 1,
    each counted) against a dense f64 oracle; then for each filter the
    logpdf, its ∇, the marginals at 1024 points, ``mean_and_cov`` at 64 and
    the 64 × 32 cross block, and 256 FFBS samples at the 64 points, against
    the oracle (and the logpdf against the dense fused one), with host ms
    per call and a step; the comparators' kernels against their plain
    versions on their inputs. Returns (ok, launches by run, checks)."""
    import numpy as np
    import torch

    import abstractgps_tpu_torch as agt
    from abstractgps_tpu_torch.models import markov

    c = MARKOV
    f32, n, M, S = torch.float32, c["n_val"], c["m_val"], c["samples"]
    rng = np.random.default_rng(seed + 40)

    def draw(size, sort=False):
        a = rng.uniform(0.0, c["t_val"], size=size)
        return torch.as_tensor(np.sort(a) if sort else a, dtype=f32, device=dev)

    t = draw(n, sort=True)
    y = torch.as_tensor(rng.normal(size=n), dtype=f32, device=dev)
    xm, xj, xc = draw(M), draw(c["m_joint"]), draw(c["m_cross"])
    kernel = c["s2"] * agt.with_lengthscale(agt.Matern32Kernel(), c["ell"])
    fx = agt.GP(kernel.to(device=dev, dtype=f32))(t, c["noise"])
    with torch.no_grad():
        ref = markov_dense_f64(t, y, xm, xj, xc, c)
    g_ref = grad_oracle_f64(c["s2"], c["ell"], t[:, None], y, noise=c["noise"])
    torch.cuda.empty_cache()
    kappa, runs = ref["kappa"], {}
    tol_dense = 10.0 * kappa * EPS32
    print(f"[markov val] N={n} t ~ sort(U(0, {c['t_val']:g})), σ²·Matérn-3/2 ℓ={c['ell']}, "
          f"noise {c['noise']}, f32; f64 logpdf {ref['lp']:.6f}; kappa<= {kappa:.3e}",
          flush=True)

    # ---- the dense comparators (kernels 1, 2, 4, 5 at D = 1) ----------------
    with capture_first_input("gram_tile", "fused_gram",
                             key=lambda a: (a[0].shape[0], a[1].shape[0])) as c1, \
            capture_first_input("slab_factor") as c2, capture_first_input("tri_inv_block") as c4:
        with torch.no_grad():
            reset_launches()
            lp_d = float(fx.logpdf(y))
            torch.cuda.synchronize()
            runs["markov dense logpdf"] = read_launches()
            reset_launches()
            mu_d, var_d = agt.posterior(fx, y).mean_and_var(xm)
            torch.cuda.synchronize()
            runs["markov dense pred"] = read_launches()
        reset_launches()
        _, g_d = markov_value_and_grad(markov_theta(f32, dev, c), t, y,
                                       lambda f, yy: f.logpdf(yy))
        runs["markov dense grad"] = read_launches()
    e_d = _rel(lp_d, ref["lp"])
    e_dm = float((mu_d.double() - ref["mean"]).abs().max() / ref["mean"].abs().max())
    e_dv = float((var_d.double() - ref["var"]).abs().max() / ref["var"].max())
    ok = e_d <= MARKOV_F32 and e_dm <= tol_dense and e_dv <= tol_dense
    print(f"[markov val] dense fused logpdf {lp_d:.6f}: rel error vs f64 {e_d:.3e} (bound "
          f"{MARKOV_F32:g}); mean_and_var at M={M}: mean {e_dm:.3e}, var {e_dv:.3e} "
          f"(10·κ·eps = {tol_dense:.3e}); launches logpdf "
          f"{json.dumps(runs['markov dense logpdf'])}, mean_and_var "
          f"{json.dumps(runs['markov dense pred'])}, ∇ {json.dumps(runs['markov dense grad'])}; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    ok = check_grads(f"markov val dense grad N={n}", g_d, g_ref, kappa, budget=False) and ok

    # ---- each filter: logpdf, ∇, marginals, joint posterior, FFBS -----------
    for parallel in (False, True):
        tag = f"markov val {'parallel' if parallel else 'sequential'}"
        times = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3
            runs[f"{tag} {name}"] = read_launches()
            return out

        with torch.no_grad():
            lp_m = float(timed("logpdf", lambda: markov.markov_logpdf(fx, y, parallel)))
            mu, var = timed("mean_and_var",
                            lambda: markov.markov_mean_and_var(fx, y, xm, parallel))
            post = markov.markov_posterior(fx, y, parallel)
            mu_j, C_j = timed("mean_and_cov", lambda: post.mean_and_cov(xj))
            C_jc = timed("cov", lambda: post.cov(xj, xc))
            gen = torch.Generator(device=dev).manual_seed(seed + 41)
            smp = timed("rand", lambda: post.rand(gen, xj, S))
        _, g_m = timed("grad", lambda: markov_value_and_grad(
            markov_theta(f32, dev, c), t, y,
            lambda f, yy: markov.markov_logpdf(f, yy, parallel)))
        launched = {r: {k: v for k, v in runs[r].items() if v}
                    for r in runs if r.startswith(tag)}
        ok_l = not any(launched.values())
        e_lp, e_vs_dense = _rel(lp_m, ref["lp"]), _rel(lp_m, lp_d)
        r_g, r_gd = _rel(g_m, g_ref), _rel(g_m, g_d)
        e_m = float((mu.double() - ref["mean"]).abs().max() / ref["mean"].abs().max())
        e_v = float((var.double() - ref["var"]).abs().max() / ref["var"].max())
        e_md = float((mu - mu_d).abs().max() / mu_d.abs().max())
        e_vd = float((var - var_d).abs().max() / var_d.max())
        cmax = float(ref["cov_j"].abs().max())
        e_mj = float((mu_j.double() - ref["mean_j"]).abs().max() / ref["mean_j"].abs().max())
        e_cj = float((C_j.double() - ref["cov_j"]).abs().max()) / cmax
        e_cjc = float((C_jc.double() - ref["cov_jc"]).abs().max()) / cmax
        # FFBS: the sample moments at each point within 5 standard errors
        # (mean: sd/√S; variance: sd²·√(2/(S−1))) plus the f32 contract on
        # the scale
        s64 = smp.double()
        sd = torch.sqrt(torch.diagonal(ref["cov_j"]))
        tol_m = 5.0 * sd / math.sqrt(S) + MARKOV_F32 * float(ref["mean_j"].abs().max())
        tol_v = 5.0 * sd * sd * math.sqrt(2.0 / (S - 1)) + MARKOV_F32 * cmax
        q_m = float(((s64.mean(1) - ref["mean_j"]).abs() / tol_m).max())
        q_v = float(((s64.var(1) - sd * sd).abs() / tol_v).max())
        ok_p = (ok_l and e_lp <= MARKOV_F32 and e_vs_dense <= MARKOV_VS_DENSE
                and bool(torch.isfinite(g_m).all()) and max(r_g) <= MARKOV_F32
                and max(e_m, e_v, e_mj, e_cj, e_cjc) <= MARKOV_F32
                and tuple(smp.shape) == (c["m_joint"], S) and q_m <= 1.0 and q_v <= 1.0)
        print(f"[{tag}] logpdf {lp_m:.6f}: rel vs f64 {e_lp:.3e}, vs the dense fused "
              f"{e_vs_dense:.3e} (bounds {MARKOV_F32:g}, {MARKOV_VS_DENSE:g}); ∇ "
              f"{g_m.tolist()}: rel vs f64 {r_g} (bound {MARKOV_F32:g}), vs the fused ∇ "
              f"{r_gd}; mean_and_var at M={M} vs f64: mean {e_m:.3e}, var {e_v:.3e} (vs the "
              f"dense fused {e_md:.3e}, {e_vd:.3e}); mean_and_cov at {c['m_joint']}: mean "
              f"{e_mj:.3e}, cov {e_cj:.3e}; cov {c['m_joint']}×{c['m_cross']} {e_cjc:.3e} (of "
              f"max|C|; bound {MARKOV_F32:g}); {S} samples: largest mean error / tolerance "
              f"{q_m:.3f}, variance {q_v:.3f} (5 standard errors + {MARKOV_F32:g} of the "
              f"scale); port kernels launched {json.dumps(launched)}; "
              f"{'ok' if ok_p else 'FAIL'}", flush=True)
        per_step = "" if parallel else (
            f"; ms a step: filter {times['logpdf'] / n:.4f} (logpdf, {n} steps), filter + "
            f"smoother {times['mean_and_var'] / (n + M):.4f} (mean_and_var, {n + M} steps), "
            f"filter + FFBS {times['rand'] / (n + c['m_joint']):.4f} (rand, "
            f"{n + c['m_joint']} steps)")
        print(f"[{tag}] host ms: " + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
              + per_step, flush=True)
        ok = ok and ok_p
    panel = next(v for k, v in c1.calls.items() if sorted(k) == [n // 8, n])
    checks = {"gram_tile panel": forward_kernel_check("gram_tile", panel, gram_tol=3e-5),
              "slab_factor": forward_kernel_check("slab_factor", c2.calls[None]),
              "tri_inv_block": forward_kernel_check("tri_inv_block", c4.calls[None])}
    checks = report_checks("markov val", checks)
    ok = ok and all(r["ok"] for r in checks.values())
    missing = {r: [k for k in ks if runs[r][k] == 0] for r, ks in MARKOV_DENSE_KERNELS.items()}
    missing = {r: ks for r, ks in missing.items() if ks}
    if missing:
        print(f"[markov val] FAIL: a dense comparator did not launch {missing}", flush=True)
        ok = False
    return ok, runs, checks



# ---------------------------------------------------------------------------
# [cg grad]: ∇ of the CG posterior's mean_and_var at the [cg] configuration
# ---------------------------------------------------------------------------

CG_GRAD_M = 256  # test points of the ∇


def cg_grad_oracle_f64(x, y, xs, solves, s2=1.0, ell=1.0, noise=0.1):
    """Dense f64 reference of [cg grad] on the card, written apart from the
    port: ∇ of L = Σ mean + Σ var in x*, σ², ℓ and the noise, in closed form
    from ∂L/∂Ks = G and ∂L/∂A = Ā (Ks = K(X, x*), A = K + noise·I, ∂A/∂noise
    = I): exactly, with α = A⁻¹y, W = A⁻¹Ks, u = W·1, G = α1ᵀ − 2W and Ā =
    WWᵀ − uαᵀ; and at the port's own f32 solves (``solves``: name → (X, B)
    for "alpha", "W" and the backward's "W backward" (B̄ = A⁻¹(−Ks)) and
    "alpha backward" (A⁻¹Ks·1)), the formula its backward evaluates: G =
    α1ᵀ − W + B̄, Ā = −B̄Wᵀ − (A⁻¹Ks·1)αᵀ. Returns both, and each solve's
    largest true relative residual ‖AX − B‖/‖B‖ over its columns."""
    import torch

    n = x.shape[0]
    out = {}
    with torch.no_grad():
        A = matern32_f64(x, x, s2, ell)
        A.diagonal().add_(noise)
        out["res_rel"] = {k: float(((A @ X.double() - B.double()).norm(dim=0)
                                    / B.double().norm(dim=0)).max())
                          for k, (X, B) in solves.items()}
        L = torch.linalg.cholesky(A)
        del A
        y64, x64, xs64 = y.double(), x.double(), xs.double()
        alpha = torch.cholesky_solve(y64[:, None], L)[:, 0]
        Ks = matern32_f64(x, xs, s2, ell)
        W = torch.cholesky_solve(Ks, L)
        del L
        u = W.sum(1)
        a_p = solves["alpha"][0].double()[:, 0]
        W_p = solves["W"][0].double()
        B_p = solves["W backward"][0].double()
        u_p = solves["alpha backward"][0].double()[:, 0]
        Gs = {"exact": alpha[:, None] - 2.0 * W, "port": a_p[:, None] - W_p + B_p}
        t = math.sqrt(3.0) / ell * torch.cdist(x64, xs64)
        e = torch.exp(-t)
        c = -3.0 * s2 / ell ** 2
        dKs = [Ks / s2, s2 * t * t * e / ell]  # ∂Ks/∂σ², ∂Ks/∂ℓ
        g = {}
        for k, G in Gs.items():
            Ge = G * e  # ∂k(x_i, x*_j)/∂x*_j = c·e_ij·(x*_j − x_i)
            g[k] = {"x": c * (xs64 * Ge.sum(0)[:, None] - Ge.T @ x64),
                    "th": [float((G * d).sum()) + (Ks.shape[1] if i == 0 else 0.0)
                           for i, d in enumerate(dKs)]}
        del t, e, dKs
        # ⟨Ā, ∂K⟩ as Σ ⟨left, ∂K·right⟩: exact (WWᵀ − uαᵀ), port (−B̄Wᵀ − u_pα_pᵀ)
        m = W.shape[1]
        R = torch.cat([W, alpha[:, None], W_p, a_p[:, None]], dim=1)
        Lf = {"exact": torch.cat([W, -u[:, None]], dim=1),
              "port": torch.cat([-B_p, -u_p[:, None]], dim=1)}
        cols = {"exact": slice(0, m + 1), "port": slice(m + 1, 2 * m + 2)}
        for r0 in range(0, n, 2048):
            rows = slice(r0, r0 + 2048)
            tt = math.sqrt(3.0) / ell * torch.cdist(x64[rows], x64)
            ee = torch.exp(-tt)
            for i, dK in enumerate(((1.0 + tt) * ee, s2 * tt * tt * ee / ell)):
                P = dK @ R
                for k in ("exact", "port"):
                    g[k]["th"][i] += float((Lf[k][rows] * P[:, cols[k]]).sum())
        for k in ("exact", "port"):
            g[k]["th"].append(float((Lf[k] * R[:, cols[k]]).sum()))  # tr(Ā)
    out["grad_x"] = g["exact"]["x"].cpu()
    out["grad_theta"] = torch.tensor(g["exact"]["th"], dtype=torch.float64)
    out["port_x"] = g["port"]["x"].cpu()
    out["port_theta"] = torch.tensor(g["port"]["th"], dtype=torch.float64)
    return out


# the [cg grad] limits, each between the error a right backward shows and
# the O(1) error of a fault (a sign, a factor, a missing term, a solve
# against the wrong operator); (e): f32 rounding of the backward's N-term
# contractions; (f): the CG error of f32 solves to tol √eps32, which costs
# ∇θ a few per cent and ∇x* far less
CG_GRAD_LIMITS = {"e theta": 1e-2, "e x*": 1e-2, "f theta": 0.1, "f x*": 1e-2}


def cg_grad_verdict(gx, gth, ref, tol):
    """The [cg grad] checks of the port's ∇x* (``gx``) and ∇(σ², ℓ, noise)
    (``gth``) against ``cg_grad_oracle_f64``'s ``ref``: (a) each of the four
    solves' true relative residual within 4·tol, as [cg]'s (a); (e) the ∇
    against the f64 formula at the port's own solves (the backward's
    algebra) and (f) against the exact ∇, each ∇θ entry within
    ``CG_GRAD_LIMITS`` times its size, ∇x* within the limit times
    max|∇x*|. Returns (ok, error / limit by check: each θ entry, the
    largest over x*, the largest residual over 4·tol)."""
    import torch

    ratios = {"a": max(ref["res_rel"].values()) / (4.0 * tol)}
    for chk, key in (("e", "port"), ("f", "grad")):
        th, xx = ref[f"{key}_theta"], ref[f"{key}_x"]
        ratios[f"{chk} theta"] = ((gth - th).abs()
                                  / (CG_GRAD_LIMITS[f"{chk} theta"] * th.abs())).tolist()
        ratios[f"{chk} x*"] = float((gx - xx).abs().max()
                                    / (CG_GRAD_LIMITS[f"{chk} x*"] * xx.abs().max()))
    finite = bool(torch.isfinite(gx).all()) and bool(torch.isfinite(gth).all())
    worst = [v if isinstance(v, float) else max(v) for v in ratios.values()]
    return finite and all(v <= 1.0 for v in worst), ratios


def run_cg_grad(seed, dev):
    """[cg grad]: ``torch.autograd.grad`` of Σmean + Σvar of the CG
    posterior's ``mean_and_var`` at 256 points, in x* and in (σ², ℓ, noise)
    (caller tensors), at the [cg] configuration (``CGInference()``'s
    defaults); launches of the forward and of the backward, the backward's
    host ms, and the ∇ against ``cg_grad_oracle_f64`` (``cg_grad_verdict``:
    the four solves' residuals, the backward's algebra and the CG error).
    Returns (ok, launches by run)."""
    import torch

    import abstractgps_tpu_torch as agt
    from abstractgps_tpu_torch.models import iterative

    c = CG
    x, y, xs = cg_data(seed + 50, dev)
    xs = xs[:CG_GRAD_M].clone()
    theta = caller_theta(1.0, 1.0, dev, torch.float32)
    inf = agt.CGInference()

    def forward(xs_):
        s2, ell, nz = theta
        fx = agt.GP(s2 * agt.with_lengthscale(agt.Matern32Kernel(), ell))(x, nz)
        m, v = agt.posterior(inf, fx, y).mean_and_var(xs_)
        return m.sum() + v.sum()

    runs = {}
    xs_ = xs.clone().requires_grad_()
    with record_calls(iterative, "mbcg") as mb:
        torch.cuda.synchronize()
        reset_launches()
        out = forward(xs_)
        torch.cuda.synchronize()
        runs["cg grad forward"] = read_launches()
        reset_launches()
        t0 = time.perf_counter()
        grads = torch.autograd.grad(out, [xs_, *theta])
        torch.cuda.synchronize()
        bwd_ms = (time.perf_counter() - t0) * 1e3
        runs["cg grad backward"] = read_launches()
    # the four solves: α (posterior), W (mean_and_var), and the backward's two
    calls = [(args[1], res[0]) for args, res in mb.calls]
    fwd, bwd = calls[:2], calls[2:]
    solves = {"alpha": (fwd[0][1], fwd[0][0]), "W": (fwd[1][1], fwd[1][0])}
    for B, X in bwd:
        solves["alpha backward" if B.shape[1] == 1 else "W backward"] = (X, B)
    del mb
    profile_breakdown("cg grad backward", lambda o: torch.autograd.grad(o, theta), top=8,
                      setup=lambda: forward(xs))
    gx = grads[0].double().cpu()
    gth = torch.stack(grads[1:]).double().cpu()
    ref = cg_grad_oracle_f64(x, y, xs, solves, noise=c["noise"])
    torch.cuda.empty_cache()
    tol = torch.finfo(torch.float32).eps ** 0.5  # mbcg's default, as [cg]'s
    ok, ratios = cg_grad_verdict(gx, gth, ref, tol)
    ok = ok and all(runs["cg grad backward"].get(k, 0) > 0 for k in CG_KERNELS)

    def fmt(v):
        return [float(f"{u:.3e}") for u in v] if isinstance(v, list) else float(f"{v:.3e}")

    print(f"[cg grad] N={c['n']} D={c['d']} f32, ∇ of Σmean + Σvar of mean_and_var at "
          f"{CG_GRAD_M} points: launches forward {json.dumps(runs['cg grad forward'])}, "
          f"backward {json.dumps(runs['cg grad backward'])}; backward host ms {bwd_ms:.3f}; "
          f"(a) true f64 relative residuals max "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in ref['res_rel'].items()})} (limit "
          f"4·tol = {4 * tol:.3e})", flush=True)
    print(f"[cg grad] ∇(s2, ell, noise) {[round(v, 5) for v in gth.tolist()]}; (e) the f64 "
          f"formula at the port's solves {[round(v, 5) for v in ref['port_theta'].tolist()]}; "
          f"(f) exact f64 {[round(v, 5) for v in ref['grad_theta'].tolist()]}; max|∇x*| "
          f"{float(ref['grad_x'].abs().max()):.3e}; error / limit "
          f"{json.dumps({k: fmt(v) for k, v in ratios.items()})} (limits "
          f"{json.dumps(CG_GRAD_LIMITS)} of |∇θ| entry by entry and of max|∇x*|); "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok, runs


# ---------------------------------------------------------------------------
# [dp elbo], [dp nuts]: a 2-rank gloo world on the one card
# ---------------------------------------------------------------------------

DP = dict(world=2, steps=5, chains=4, warmup=20, draws=20)
DP_STEP_LAUNCHES = SVGP_STEP_LAUNCHES  # the collapsed ∇: 2 gram_tile, 3 gram_bwd


def dp_theta0(x):
    """The raw tree of [dp elbo]: σ² = 1, ARD = 1, noise 0.1, z = the first
    512 inputs."""
    import torch

    import abstractgps_tpu_torch.params as P

    d = x.shape[1]
    return {"s2": P.positive(torch.tensor(1.0, device=x.device)),
            "ard": P.positive(torch.ones(d, device=x.device)),
            "noise2": P.positive(torch.tensor(0.1, device=x.device)),
            "z": P.real(x[:SPARSE["m"]].clone())}


def dp_loss(rt, data):
    """−ELBO of VFE(f(z, 1e-6)) at f(x, noise2), the example's model."""
    import abstractgps_tpu_torch as agt
    import abstractgps_tpu_torch.params as P

    th = P.constrain(rt)
    x_, y_ = data
    f = agt.GP(ard_kernel(th["s2"], th["ard"]))
    return -agt.elbo(agt.VFE(f(th["z"], JITTER)), f(x_, th["noise2"]), y_)


def _dp_rank(rank, world, store, outdir, seed, sizes, dev_type):
    """One rank of the [dp elbo] / [dp nuts] / [tp ...] world
    (``torch.multiprocessing`` spawn target; ``sizes`` are the parent's
    SPARSE, HYPER, DP, CG and TP): results to ``outdir/dp_rank<r>.json``."""
    import torch

    import abstractgps_tpu_torch as agt
    from abstractgps_tpu_torch.inference.mcmc import (
        init_chain_positions,
        logdensity_and_grad,
        run_mcmc,
    )
    from abstractgps_tpu_torch.ops import cuda
    from abstractgps_tpu_torch.parallel import fit_sharded, initialize_distributed, make_mesh
    from abstractgps_tpu_torch.parallel import collectives as col
    from abstractgps_tpu_torch.parallel.mesh import shard_along

    for name, val in sizes.items():
        globals()[name].update(val)
    dev = torch.device(dev_type)
    agt.set_default_device(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    if dev.type == "cuda":
        cuda.library()  # built by the parent
    initialize_distributed(f"file://{store}", world, rank, timeout=600)
    mesh = make_mesh(world)
    group = mesh.get_group("dp")
    out = {"backend": torch.distributed.get_backend()}
    c = SPARSE
    x, y, _ = sparse_data(seed + 60, dev, c["n"], c["d"])
    theta0 = dp_theta0(x)
    import abstractgps_tpu_torch.params as P

    # the ELBO and its ∇ in the constrained leaves at θ0, sharded
    th = P.constrain(theta0)
    leaves = [th[k].detach().clone().requires_grad_() for k in ("s2", "ard", "noise2", "z")]
    f = agt.GP(ard_kernel(leaves[0], leaves[1]))
    xl, yl = shard_along(x, mesh), shard_along(y, mesh)
    with col.data_axis(group):
        e = agt.elbo(agt.VFE(f(leaves[3], JITTER)), f(xl, leaves[2]), yl)
    gr = torch.autograd.grad(e, leaves)
    flat = col.all_reduce(torch.cat([g.reshape(-1) for g in gr]), group) / world
    out["elbo"] = float(e.detach())
    out["grad"] = flat.double().cpu().tolist()
    out["rows"] = xl.shape[0]
    # fit_sharded: per step launches, collectives and ms, after one warm step
    # (a process's first optimizer step pays one-off imports)
    # rank 0 keeps the kernels' inputs of this step for the parent's checks
    with capture_first_input("gram_tile", "fused_gram", key=_sym_key) as c1, \
            capture_first_input("gram_bwd", "fused_gram", key=lambda a: a[6]) as c6:
        fit_sharded(dp_loss, theta0, (x, y), mesh, num_steps=1, learning_rate=3e-2)
    if rank == 0:
        torch.save({"gram_tile": c1.calls, "gram_bwd": c6.calls},
                   os.path.join(outdir, "dp_kernel_inputs.pt"))
    del c1, c6
    sync()
    col.reset_collectives()
    cuda.reset_launches()
    t0 = time.perf_counter()
    res = fit_sharded(dp_loss, theta0, (x, y), mesh, num_steps=DP["steps"], learning_rate=3e-2)
    sync()
    out["fit_ms"] = (time.perf_counter() - t0) * 1e3
    out["fit_launches"] = dict(cuda.LAUNCHES)
    out["fit_collectives"] = dict(col.COLLECTIVES)
    out["fit_bytes"] = dict(col.COLLECTIVE_BYTES)
    out["history"] = res.history.double().cpu().tolist()
    out["theta"] = [t.detach().double().cpu().reshape(-1).tolist() for t in P.leaves(res.params)]
    if dev.type == "cuda":
        profile_breakdown(f"dp elbo step rank {rank}",
                          lambda: fit_sharded(dp_loss, theta0, (x, y), mesh, num_steps=1,
                                              learning_rate=3e-2), top=8)
    # [dp nuts]: chain-sharded hyper NUTS, no collective while sampling
    h = HYPER
    import numpy as np

    rng = np.random.default_rng(seed + 10)
    xh = torch.as_tensor(rng.uniform(size=(h["n"], h["d"])), dtype=torch.float32, device=dev)
    yh = torch.as_tensor(rng.normal(size=h["n"]), dtype=torch.float32, device=dev)
    logdens = hyper_logdensity(xh, yh)
    init = init_chain_positions(seed, torch.zeros(3, dtype=torch.float32, device=dev),
                                num_chains=DP["chains"], jitter=h["jitter"])
    fgrad = logdensity_and_grad(logdens, lambda v: v, "loop")
    cuda.reset_launches()
    fgrad(init[rank * 2:rank * 2 + 1])
    sync()
    out["nuts_per_grad"] = dict(cuda.LAUNCHES)
    col.reset_collectives()
    cuda.reset_launches()
    t0 = time.perf_counter()
    r = run_mcmc(logdens, init, seed, num_chains=DP["chains"], num_warmup=DP["warmup"],
                 num_samples=DP["draws"], max_depth=h["max_depth"], chain_eval="loop",
                 mesh=mesh)
    sync()
    out["nuts_s"] = time.perf_counter() - t0
    out["nuts_collectives"] = dict(col.COLLECTIVES)
    out["nuts_launches"] = dict(cuda.LAUNCHES)
    out["nuts_chains"] = list(r.positions.shape)
    out["nuts_finite"] = bool(torch.isfinite(r.positions).all() and torch.isfinite(r.logdens).all())
    out["nuts_leapfrogs"] = int(r.num_steps.sum())
    out["tp"] = _tp_rank(rank, world, outdir, seed, dev, sync)
    with open(os.path.join(outdir, f"dp_rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()


def run_dp(seed, dev):
    """[dp elbo] and [dp nuts]: a 2-rank world on the one card (gloo: NCCL
    refuses two ranks on one GPU), spawned with ``torch.multiprocessing``;
    a rank's failure fails the phase. [dp elbo] (BASELINE config 3, 25 000
    points a rank): the sharded ELBO and ∇ at θ0 against ``vfe_f64``, then 5
    ``fit_sharded`` steps against the unsharded ``fit`` of the same loss
    here, with each rank's launches, collectives and ms per step. [dp nuts]:
    chain-sharded hyper NUTS at the [mcmc hyper] target, 2 chains a rank.
    The same world then runs the tp phases (``_tp_rank``; ``run_tp`` checks
    them). Returns (ok, launches by run, the kernels' checks, (the world's
    directory, each rank's results))."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    import abstractgps_tpu_torch as agt
    import abstractgps_tpu_torch.params as P
    from abstractgps_tpu_torch.inference.mcmc import init_chain_positions, logdensity_and_grad

    w = DP["world"]
    tmp = tempfile.mkdtemp(prefix="dp_")
    t0 = time.perf_counter()
    sizes = {"SPARSE": SPARSE, "HYPER": HYPER, "DP": DP, "CG": CG, "TP": TP}
    mp.spawn(_dp_rank, args=(w, os.path.join(tmp, "store"), tmp, seed, sizes, dev.type),
             nprocs=w, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(w):
        with open(os.path.join(tmp, f"dp_rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    c = SPARSE
    x, y, _ = sparse_data(seed + 60, dev, c["n"], c["d"])
    theta0 = dp_theta0(x)
    # the unsharded fit of the same loss, timed the same way (after a warm step)
    agt.fit(lambda rt: dp_loss(rt, (x, y)), theta0, num_steps=1, learning_rate=3e-2)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ref = agt.fit(lambda rt: dp_loss(rt, (x, y)), theta0, num_steps=DP["steps"],
                  learning_rate=3e-2)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    ref_launches = read_launches()
    h_ref = ref.history.double().cpu()
    th_ref = [t.detach().double().cpu().reshape(-1) for t in P.leaves(ref.params)]
    # the ELBO and ∇ at θ0 in f64
    th = P.constrain(theta0)
    l64 = [th[k].detach().double().requires_grad_() for k in ("s2", "ard", "noise2", "z")]
    e64, _, k_zz, k_lam = vfe_f64(*l64, x, y)
    want = torch.autograd.grad(e64, l64)
    kappa = max(k_zz, k_lam)
    tol_g = GRAD_KAPPA_FACTOR * kappa * EPS32
    ok = True
    runs = {}
    for r, res in enumerate(ranks):
        g = torch.tensor(res["grad"], dtype=torch.float64)
        got, i = [], 0
        for wv in want:
            got.append(g[i:i + wv.numel()].reshape(wv.shape))
            i += wv.numel()
        errs = leaf_errors(got, want)
        e_err = abs(res["elbo"] - float(e64.detach())) / abs(float(e64.detach()))
        h = torch.tensor(res["history"], dtype=torch.float64)
        h_err = float(((h - h_ref).abs() / h_ref.abs()).max())
        th_err = max(float((torch.tensor(a) - b).abs().max() / b.abs().max())
                     for a, b in zip(res["theta"], th_ref))
        per_step = {k: v / DP["steps"] for k, v in res["fit_launches"].items() if v}
        coll = {k: v / DP["steps"] for k, v in res["fit_collectives"].items() if v}
        nbytes = {k: v / DP["steps"] for k, v in res["fit_bytes"].items() if v}
        launch_ok = all(per_step.get(k) == v for k, v in DP_STEP_LAUNCHES.items())
        good = (res["backend"] == "gloo" and res["rows"] == c["n"] // w
                and all(e_ <= tol_g for e_ in errs) and e_err <= _tol_rel(kappa)
                and h_err <= tol_g and th_err <= tol_g and launch_ok)
        print(f"[dp elbo] rank {r}/{w} ({res['backend']}, {res['rows']} points): ELBO at θ0 "
              f"{res['elbo']:.4f} (f64 {float(e64.detach()):.4f}, rel error {e_err:.3e}, tol "
              f"{_tol_rel(kappa):.3e}); ∇ error / max|∇| by leaf "
              f"{json.dumps(dict(zip(('s2', 'ard', 'noise', 'z'), errs)))} (tol {tol_g:.3e}); "
              f"{DP['steps']} fit_sharded steps: history {res['history']} vs unsharded fit, max "
              f"rel error {h_err:.3e}, final θ max rel error {th_err:.3e} (tol {tol_g:.3e}); per "
              f"step: launches {json.dumps(per_step)}, collectives {json.dumps(coll)} "
              f"({json.dumps(nbytes)} bytes), {res['fit_ms'] / DP['steps']:.3f} ms "
              f"(unsharded {ref_ms / DP['steps']:.3f} ms, launches "
              f"{json.dumps({k: v / DP['steps'] for k, v in ref_launches.items() if v})}); "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok = ok and good
        runs[f"dp elbo step rank {r}"] = {k: v // DP["steps"] for k, v in res["fit_launches"].items()}
    # [dp nuts]: one chain's ∇logpdf launches as unsharded, no collective
    hc = HYPER
    import numpy as np

    rng = np.random.default_rng(seed + 10)
    xh = torch.as_tensor(rng.uniform(size=(hc["n"], hc["d"])), dtype=torch.float32, device=dev)
    yh = torch.as_tensor(rng.normal(size=hc["n"]), dtype=torch.float32, device=dev)
    init = init_chain_positions(seed, torch.zeros(3, dtype=torch.float32, device=dev),
                                num_chains=DP["chains"], jitter=hc["jitter"])
    fgrad = logdensity_and_grad(hyper_logdensity(xh, yh), lambda v: v, "loop")
    # rank 0's first ∇logpdf, on the same data and chain: its kernels' inputs
    with capture_first_input("gram_tile", "fused_gram") as c1, \
            capture_first_input("slab_factor") as c2, \
            capture_first_input("tri_inv_block") as c4, \
            capture_first_input("logpdf_contraction", "fused_gram") as c5:
        reset_launches()
        fgrad(init[:1])
        torch.cuda.synchronize()
        per_grad = read_launches()
    nuts_in = {"gram_tile": c1.calls.get(None), "slab_factor": c2.calls.get(None),
               "tri_inv_block": c4.calls.get(None), "logpdf_contraction": c5.calls.get(None)}
    del c1, c2, c4, c5
    for r, res in enumerate(ranks):
        good = (res["nuts_finite"] and not any(res["nuts_collectives"].values())
                and res["nuts_chains"] == [DP["chains"] // w, DP["draws"], 3]
                and res["nuts_per_grad"] == per_grad
                and all(res["nuts_launches"].get(k, 0) > 0 for k in HYPER_KERNELS))
        print(f"[dp nuts] rank {r}/{w}: {DP['chains'] // w} chains, {DP['warmup']} warmup + "
              f"{DP['draws']} draws, N={hc['n']}: {res['nuts_leapfrogs']} leapfrogs in "
              f"{res['nuts_s']:.3f} s; collectives while sampling "
              f"{json.dumps(res['nuts_collectives'])}; one ∇logpdf's launches "
              f"{json.dumps(res['nuts_per_grad'])} (unsharded {json.dumps(per_grad)}); launches "
              f"{json.dumps({k: v for k, v in res['nuts_launches'].items() if v})}; "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok = ok and good
        runs[f"dp nuts rank {r}"] = res["nuts_launches"]
    print(f"[dp] the 2-rank world (spawn, build loaded, both phases, join) took {spawn_s:.1f} s",
          flush=True)
    checks = dp_kernel_checks(torch.load(os.path.join(tmp, "dp_kernel_inputs.pt"),
                                         map_location=dev, weights_only=False), nuts_in)
    ok = ok and all(r["ok"] for r in checks.values())
    return ok, runs, checks, (tmp, ranks)


def dp_kernel_checks(elbo_in, nuts_in):
    """The kernels of [dp elbo] and [dp nuts] against their plain versions
    on the path's own inputs: ``elbo_in`` holds rank 0's ``gram_tile``
    (Kxz on its 25 000-row shard, Kzz) and ``gram_bwd`` (three modes)
    arguments of one ``fit_sharded`` step, ``nuts_in`` those of the first
    ∇logpdf of rank 0's first chain. Tolerances as in [sparse] and [mcmc
    hyper]; the gram tiles and the backward's modes timed beside their
    bounds. Returns name → dict(max_abs_err, shape, ok[, device_ms,
    bound_ms])."""
    import torch

    out = {f"gram_tile {'sym' if k else 'cross'}": forward_kernel_check("gram_tile", a)
           for k, a in elbo_in["gram_tile"].items()}
    with torch.no_grad():
        bwd = gram_bwd_checks(elbo_in["gram_bwd"], tag="dp elbo gram_bwd")
    out["gram_bwd"] = (bwd["max_abs_err"], "x̄ within 2·√m·eps·Σ|terms|, scalars 1e-4",
                       {m_: r["shape"] for m_, r in bwd["modes"].items()}, bwd["ok"])
    checks = report_checks("dp elbo", out)
    for k, a in elbo_in["gram_tile"].items():
        checks[f"gram_tile {'sym' if k else 'cross'}"].update(
            gram_tile_timing(f"dp elbo {'sym' if k else 'cross'}", a))
    for mode, r in bwd["modes"].items():
        checks[f"gram_bwd {mode}"] = {f: r[f] for f in ("max_abs_err", "shape", "ok",
                                                       "device_ms", "bound_ms")}
    checks.update({f"{k} nuts": v for k, v in hyper_kernel_checks(nuts_in, "dp nuts").items()})
    return checks


# ---------------------------------------------------------------------------
# [tp logpdf], [tp pred], [tp grad]: the tensor-parallel exact GP in the
# 2-rank world; [tp 1-rank]: the JAX package's own chip check, in a world of one
# ---------------------------------------------------------------------------

# [tp logpdf] and [tp pred] run on the [cg] data (N = 32 768, D = 8, 4096 test
# points; σ²·Matérn-3/2 at σ² = ℓ = 1, noise 0.1, f32) at panels of 256, the
# JAX default: 128 panels, 64 a rank. [tp grad]: the main path's problem
# (make_problem at N = 8192, M = 4096). [tp 1-rank]: examples/validate_tpu.py:
# 82-91 (N = 16 384, block 512). ``timed``: the warm calls timed after the
# counted one.
TP = dict(block=256, grad_n=8192, grad_m=4096, one_n=16384, one_block=512, timed=2)
TP_LAUNCHES = {"logpdf": {"gram_tile": 1}, "pred": {"gram_tile": 2},
               "grad": {"gram_tile": 1, "gram_bwd": 2}}
TP_ONE_LIMIT = 1e-3  # examples/validate_tpu.py:90, relative to the dense logpdf


def tp_collectives(nb: int, grad: bool = False) -> dict:
    """The collectives of one sweep of ``nb`` panels: a broadcast of the
    owner's block each panel, an all_gather of the panel column each panel
    but the last; with the ∇ an all-reduce for each of them and one for the
    replicated inputs."""
    return {"all_reduce": 2 * nb if grad else 0, "all_gather": nb - 1, "broadcast": nb}


def _tp_rank(rank, world, outdir, seed, dev, sync):
    """[tp logpdf], [tp pred] and [tp grad] on this rank of the 2-rank world
    (``make_mesh(2, ("tp",))``): each counted (launches, collectives, bytes,
    host ms) in its first call, then timed over ``TP["timed"]`` warm calls;
    rank 0 profiles one logpdf and one prediction (rank 1 makes the same
    calls, which meet rank 0's in the collectives) and saves its kernels'
    inputs for the parent. Returns this rank's results."""
    import torch

    import abstractgps_tpu_torch as agt
    from abstractgps_tpu_torch.ops import cuda
    from abstractgps_tpu_torch.parallel import make_mesh, sharded_logpdf, sharded_mean_and_var
    from abstractgps_tpu_torch.parallel import collectives as col

    c = TP
    mesh = make_mesh(world, ("tp",))
    x, y, xs = cg_data(seed + 50, dev)
    kernel = make_kernel(1.0, 1.0, dev, torch.float32)

    def logpdf():
        with torch.no_grad():
            return sharded_logpdf(agt.GP(kernel)(x, NOISE), y, mesh, block=c["block"])

    def pred():
        with torch.no_grad():
            return sharded_mean_and_var(agt.GP(kernel)(x, NOISE), y, xs, mesh, block=c["block"])

    xg, yg, _, s2, ell = make_problem(seed, c["grad_n"], c["grad_m"], CG["d"], dev,
                                      torch.float32)
    theta = caller_theta(s2, ell, dev, torch.float32)

    def grad():
        s2_, ell_, noise = theta
        fx = agt.GP(s2_ * agt.with_lengthscale(agt.Matern32Kernel(), ell_))(xg, noise)
        lp = sharded_logpdf(fx, yg, mesh, block=c["block"])
        return torch.stack(torch.autograd.grad(lp, theta))

    out, inputs = {}, {}
    for name, fn, kname, key in (("logpdf", logpdf, "gram_tile", lambda a: a[1].shape[0]),
                                 ("pred", pred, "gram_tile", lambda a: a[1].shape[0]),
                                 ("grad", grad, "gram_bwd", lambda a: a[6])):
        with capture_first_input(kname, "fused_gram", key=key) as cap:
            sync()
            col.reset_collectives()
            cuda.reset_launches()
            t0 = time.perf_counter()
            res = fn()
            sync()
            r = {"first_ms": (time.perf_counter() - t0) * 1e3, "launches": dict(cuda.LAUNCHES),
                 "collectives": dict(col.COLLECTIVES), "bytes": dict(col.COLLECTIVE_BYTES)}
        inputs[name] = cap.calls
        res = res if isinstance(res, tuple) else (res,)
        r["value"] = [t.double().cpu().reshape(-1).tolist() for t in res]
        r["ms"] = host_ms(fn, c["timed"])
        if name != "grad":
            if rank == 0 and dev.type == "cuda":
                profile_breakdown(f"tp {name} rank 0", fn, top=8)
            else:  # the partner of rank 0's two profiled calls
                fn()
                fn()
        out[name] = r
    if rank == 0:
        torch.save(inputs, os.path.join(outdir, "tp_kernel_inputs.pt"))
    return out


def tp_oracle_f64(x, y, xs=None, s2=1.0, ell=1.0, noise=NOISE):
    """Dense f64 reference of the tp phases on the card, written apart from
    the port (``matern32_f64``, ``torch.linalg``): (logpdf, the posterior
    mean and variance at ``xs`` or None, κ ≤ λ_max/noise by power
    iteration)."""
    import torch

    n = x.shape[0]
    with torch.no_grad():
        A = matern32_f64(x, x, s2, ell)
        A.diagonal().add_(noise)
        v = torch.ones(n, dtype=torch.float64, device=x.device)
        for _ in range(50):
            v = A @ v
            v = v / v.norm()
        kappa = float(v @ (A @ v)) * 1.01 / noise
        L = torch.linalg.cholesky(A)
        del A
        z = torch.linalg.solve_triangular(L, y.double()[:, None], upper=False)[:, 0]
        lp = -0.5 * (n * math.log(2 * math.pi) + 2 * float(torch.log(torch.diagonal(L)).sum())
                     + float(z @ z))
        if xs is None:
            return lp, None, None, kappa
        V = torch.linalg.solve_triangular(L, matern32_f64(x, xs, s2, ell), upper=False)
        del L
        return lp, V.T @ z, torch.clamp(s2 - (V * V).sum(0), min=0.0), kappa


def run_tp(seed, dev, tmp, ranks):
    """[tp logpdf], [tp pred], [tp grad]: each rank's results (``_tp_rank``)
    against ``tp_oracle_f64`` (logpdf, mean, variance within 10·κ·eps) and
    ``grad_oracle_f64`` (PERF.md §2's gradient rule), the same bits on both
    ranks, the launches and collectives as predicted; the kernels against
    their plain versions on rank 0's inputs. Then [tp 1-rank]. Returns (ok,
    launches by run, the kernels' checks by name)."""
    import torch

    c = TP
    x, y, xs = cg_data(seed + 50, dev)
    nb = -(-x.shape[0] // (2 * c["block"])) * 2
    nb_grad = -(-c["grad_n"] // (2 * c["block"])) * 2
    ref = tp_oracle_f64(x, y, xs)
    torch.cuda.empty_cache()
    xg, yg, _, s2, ell = make_problem(seed, c["grad_n"], c["grad_m"], CG["d"], dev,
                                      torch.float32)
    g64 = grad_oracle_f64(s2, ell, xg, yg)
    kappa_g = kappa_f64(s2, ell, xg, NOISE)
    ok, runs = True, {}
    same = all(ranks[0]["tp"][k]["value"] == r["tp"][k]["value"]
               for r in ranks[1:] for k in ("logpdf", "pred", "grad"))
    for r, res in enumerate(ranks):
        t = res["tp"]
        lp = torch.tensor(t["logpdf"]["value"][0][0], dtype=torch.float64)
        mu, var = (torch.tensor(v, dtype=torch.float64, device=dev) for v in t["pred"]["value"])
        good = check_against_oracle(f"tp logpdf, pred rank {r} N={x.shape[0]} M={xs.shape[0]}",
                                    lp, mu, var, ref)
        good = check_grads(f"tp grad rank {r} N={c['grad_n']}",
                           torch.tensor(t["grad"]["value"][0], dtype=torch.float64), g64,
                           kappa_g) and good
        for name in ("logpdf", "pred", "grad"):
            p = t[name]
            launched = {k: v for k, v in p["launches"].items() if v}
            want_coll = tp_collectives(nb_grad if name == "grad" else nb, name == "grad")
            good_p = launched == TP_LAUNCHES[name] and p["collectives"] == want_coll
            print(f"[tp {name}] rank {r}: launches {json.dumps(launched)} (predicted "
                  f"{json.dumps(TP_LAUNCHES[name])}), collectives {json.dumps(p['collectives'])} "
                  f"(predicted {json.dumps(want_coll)}), bytes sent "
                  f"{json.dumps(p['bytes'])}; host ms: counted call {p['first_ms']:.3f}, warm "
                  f"calls {', '.join(f'{v:.3f}' for v in p['ms'])}; "
                  f"{'ok' if good_p else 'FAIL'}", flush=True)
            good = good and good_p
            runs[f"tp {name} rank {r}"] = p["launches"]
        ok = ok and good
    print(f"[tp] both ranks hold the same bits (logpdf, mean, variance, ∇): {same}", flush=True)
    ok = ok and same
    # the kernels on rank 0's own inputs
    inputs = torch.load(os.path.join(tmp, "tp_kernel_inputs.pt"), map_location=dev,
                        weights_only=False)
    slab, test = inputs["logpdf"][x.shape[0]], inputs["pred"][xs.shape[0]]
    checks = report_checks("tp", {"gram_tile slab": forward_kernel_check("gram_tile", slab),
                                  "gram_tile test": forward_kernel_check("gram_tile", test)})
    checks["gram_tile slab"].update(gram_tile_timing("tp slab", slab))
    checks["gram_tile test"].update(gram_tile_timing("tp test", test))
    with torch.no_grad():
        bwd = gram_bwd_checks(inputs["grad"], tag="tp gram_bwd")
    for mode, r in bwd["modes"].items():
        checks[f"gram_bwd {mode}"] = {f: r[f] for f in ("max_abs_err", "shape", "ok",
                                                       "device_ms", "bound_ms")}
    ok = ok and all(r["ok"] for r in checks.values()) and set(bwd["modes"]) == {"plain",
                                                                               "transpose"}
    del inputs
    torch.cuda.empty_cache()
    one_ok, runs["tp 1-rank logpdf"] = run_tp_one_rank(seed, dev)
    return ok and one_ok, runs, checks


def run_tp_one_rank(seed, dev):
    """[tp 1-rank]: ``sharded_logpdf`` on ``make_mesh(1, ("tp",))`` at
    examples/validate_tpu.py:82-91's problem, against the dense fused
    ``FiniteGP.logpdf`` (within ``TP_ONE_LIMIT``, the JAX check's own) and
    f64 (10·κ·eps). Returns (ok, its launches)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import abstractgps_tpu_torch as agt
    from abstractgps_tpu_torch.parallel import make_mesh, sharded_logpdf

    c = TP
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(size=(c["one_n"], 8)), dtype=torch.float32, device=dev)
    y = torch.as_tensor(rng.normal(size=c["one_n"]), dtype=torch.float32, device=dev)
    kernel = make_kernel(1.0, 1.0, dev, torch.float32)
    mesh = make_mesh(1, ("tp",))
    with torch.no_grad():
        reset_launches()
        t0 = time.perf_counter()
        lp = float(sharded_logpdf(agt.GP(kernel)(x, NOISE), y, mesh, block=c["one_block"]))
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        dense = float(agt.GP(kernel)(x, NOISE).logpdf(y))
    dist.destroy_process_group()  # the world of one that make_mesh joined
    lp64, _, _, kappa = tp_oracle_f64(x, y)
    torch.cuda.empty_cache()
    rel = abs(lp - dense) / abs(dense)
    e64, d64 = abs(lp - lp64) / abs(lp64), abs(dense - lp64) / abs(lp64)
    ok = (rel < TP_ONE_LIMIT and e64 <= 10.0 * kappa * EPS32
          and {k: v for k, v in launches.items() if v} == TP_LAUNCHES["logpdf"])
    print(f"[tp 1-rank] N={c['one_n']} D=8 f32, block {c['one_block']}: sharded logpdf {lp:.6f} "
          f"({ms:.3f} ms, the counted call), dense fused {dense:.6f}, f64 {lp64:.6f}; relative "
          f"to the dense {rel:.3e} (limit {TP_ONE_LIMIT:g}); to f64 {e64:.3e} (dense {d64:.3e}; "
          f"tol 10·κ·eps {10.0 * kappa * EPS32:.3e}); launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok, launches


# ---------------------------------------------------------------------------
# [utils]: checkpoint, checked, trace at full width on the card
# ---------------------------------------------------------------------------


def run_utils(post, kernel, x, y):
    """[utils]: the N = 8192 posterior cache through ``checkpoint.save`` /
    ``restore`` (bit for bit, still on the card), ``checked`` on the
    full-width logpdf with a NaN in y (must raise) and without (must pass
    the value through), ``profiling.trace`` around one full-width logpdf
    (must write a trace). Returns ok."""
    import tempfile

    import torch

    import abstractgps_tpu_torch as agt
    from abstractgps_tpu_torch.utils import checkpoint, profiling
    from abstractgps_tpu_torch.utils.debug import checked

    tmp = tempfile.mkdtemp(prefix="utils_")
    checkpoint.save(os.path.join(tmp, "cache"), post.data)
    back = checkpoint.restore(os.path.join(tmp, "cache"), post.data)
    names = ("alpha", "L", "x", "delta")
    same = all(torch.equal(getattr(back, k), getattr(post.data, k)) for k in names)
    on_card = all(getattr(back, k).is_cuda for k in names)

    def logpdf(yy):
        with torch.no_grad():
            return agt.GP(kernel)(x, NOISE).logpdf(yy)

    y_nan = y.clone()
    y_nan[17] = float("nan")
    try:
        checked(logpdf)(y_nan)
        raised = False
    except FloatingPointError as err:
        raised = "nan" in str(err).lower()
    passed = float(checked(logpdf)(y)) == float(logpdf(y))
    with profiling.trace(os.path.join(tmp, "trace")):
        logpdf(y)
        torch.cuda.synchronize()
    size = os.path.getsize(os.path.join(tmp, "trace", "trace.json"))
    ok = same and on_card and raised and passed and size > 0
    print(f"[utils] checkpoint of the N={x.shape[0]} posterior cache bit for bit {same}, leaves "
          f"on cuda {on_card}; checked logpdf with a NaN in y raised {raised}, clean value passed "
          f"through {passed}; trace of one logpdf {size} bytes; {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok

def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_script = time.perf_counter()

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

    # ---- the samplers first, while little else holds device memory --------
    t0 = time.perf_counter()
    hyper_ok, counts_hyper, hyper_checks = run_hyper_nuts(args.seed, dev)
    latent_ok = run_latent_nuts(args.seed, dev)
    ess_smc_ok = run_ess_smc(args.seed, dev)
    ok = hyper_ok and latent_ok and ess_smc_ok
    print(f"[mcmc] sampler phases took {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # ---- the sparse slice at BASELINE.json config 3 ----------------------
    t0 = time.perf_counter()
    svgp_ok, fitted, runs_svgp, checks_svgp = run_svgp(args.seed, dev)
    torch.cuda.empty_cache()
    sparse_ok, runs_sparse, checks_sparse = run_sparse(args.seed, dev, fitted)
    torch.cuda.empty_cache()
    online_ok, runs_online, checks_online = run_online(args.seed, dev, fitted)
    torch.cuda.empty_cache()
    ok = ok and svgp_ok and sparse_ok and online_ok
    print(f"[sparse slice] svgp, sparse and online phases took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- the CG backend at N = 32 768, pathwise sampling at N = 8192 -----
    t0 = time.perf_counter()
    cg_ok, runs_cg, checks_cg = run_cg(args.seed, dev)
    torch.cuda.empty_cache()
    cg_grad_ok, runs_cg_grad = run_cg_grad(args.seed, dev)
    runs_cg.update(runs_cg_grad)
    torch.cuda.empty_cache()
    pw_ok, runs_pw, checks_pw = run_pathwise(args.seed, dev)
    torch.cuda.empty_cache()
    ok = ok and cg_ok and cg_grad_ok and pw_ok
    print(f"[cg slice] cg and pathwise phases took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- the Markov backend at N = 10^6 and its cross-check at N = 8192 ----
    t0 = time.perf_counter()
    mk_ok, runs_mk, checks_mk = run_markov(args.seed, dev)
    torch.cuda.empty_cache()
    ok = ok and mk_ok
    print(f"[markov] phase took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- the parallel layer: a 2-rank world on the one card (dp, then tp) ---
    t0 = time.perf_counter()
    dp_ok, runs_dp, checks_dp, world = run_dp(args.seed, dev)
    torch.cuda.empty_cache()
    print(f"[dp] phases (the 2-rank world's tp phases included) took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    tp_ok, runs_tp, checks_tp = run_tp(args.seed, dev, *world)
    torch.cuda.empty_cache()
    ok = ok and dp_ok and tp_ok
    print(f"[tp] checks and the 1-rank phase took {time.perf_counter() - t0:.1f} s", flush=True)
    t_main = time.perf_counter()

    # ---- the main path: full width, then the ragged width -----------------
    N, M, D, N_RAGGED, M_RAGGED = 8192, 4096, 8, 4500, 1024
    x, y, xs, s2, ell = make_problem(args.seed, N, M, D, dev, f32)
    kernel = make_kernel(s2, ell, dev, f32)
    xr, yr, xsr, s2r, ellr = make_problem(args.seed + 1, N_RAGGED, M_RAGGED, D, dev, f32)
    kernel_r = make_kernel(s2r, ellr, dev, f32)

    with capture_first_input("slab_factor") as slab_in:
        (lp, mu, var, post), full_counts = run_path(kernel, x, y, xs)
    torch.cuda.synchronize()
    ok = run_utils(post, kernel, x, y) and ok
    with capture_first_input("chol_inv_block") as block_in:
        (lp_r, mu_r, var_r, _), ragged_counts = run_path(kernel_r, xr, yr, xsr)
    torch.cuda.synchronize()
    # ---- the training path: ∇logpdf at full width and ragged, ∇prediction,
    # then five Adam steps of MLE-II at full width -------------------------
    theta = caller_theta(s2, ell, dev, f32)
    with capture_first_input("logpdf_contraction", "fused_gram") as contr_in:
        g_full, counts_g = run_grad_path(theta, x, y)
    g_ragged, counts_gr = run_grad_path(caller_theta(s2r, ellr, dev, f32), xr, yr)
    with capture_first_input("gram_bwd", "fused_gram", key=lambda a: a[6]) as bwd_in:
        g_pred, counts_gp = run_grad_path(theta, x, y, xs)

    import abstractgps_tpu_torch.params as P

    def build_fx(t, xx):
        return agt.GP(t["s2"] * agt.with_lengthscale(agt.Matern32Kernel(), t["ell"]))(
            xx, t["noise"])

    theta0 = {k: P.positive(torch.tensor(v, dtype=f32, device=dev))
              for k, v in (("s2", s2), ("ell", ell), ("noise", NOISE))}
    reset_launches()
    fit_res = agt.fit(agt.nlml(build_fx, x, y), theta0, num_steps=5)
    hist = fit_res.history.double().cpu()
    counts_fit = read_launches()
    fit_ok = bool(torch.isfinite(hist).all()) and float(hist[-1]) <= float(hist[0])
    print(f"[fit] 5 Adam steps at N={N}: loss history {hist.tolist()}; "
          f"{'ok' if fit_ok else 'FAIL'}", flush=True)

    # ---- the deep kernel: ∇logpdf through its MLP on the fused path, then two
    # Adam steps of MLE-II over the MLP's tree and (σ², ℓ, noise) -----------
    mlp = make_mlp(args.seed + 2, dev, f32)
    g_deep, counts_deep, deep_rg = run_deep_grad(theta, mlp, x, y)
    print(f"[deep] logpdf requires grad: {deep_rg}; launches {json.dumps(counts_deep)}",
          flush=True)

    def build_deep(t, xx):
        return agt.GP(deep_kernel(t["s2"], t["ell"], t["mlp"]))(xx, t["noise"])

    theta_deep = dict(theta0, mlp=make_mlp(args.seed + 2, dev, f32))
    reset_launches()
    deep_res = agt.fit(agt.nlml(build_deep, x, y), theta_deep, num_steps=2)
    hist_deep = deep_res.history.double().cpu()
    counts_deep_fit = read_launches()
    moved = all(not torch.equal(a[k], b[k]) for a, b in zip(deep_res.params["mlp"],
                                                            theta_deep["mlp"]) for k in "wb")
    deep_fit_ok = bool(torch.isfinite(hist_deep).all()) and moved
    print(f"[deep fit] 2 Adam steps at N={N}: loss history {hist_deep.tolist()}; every MLP "
          f"tensor moved: {moved}; {'ok' if deep_fit_ok else 'FAIL'}", flush=True)

    runs = {"logpdf full": full_counts["logpdf"], "pred full": full_counts["pred"],
            "logpdf ragged": ragged_counts["logpdf"], "pred ragged": ragged_counts["pred"],
            "grad full": counts_g, "grad ragged": counts_gr, "pred grad full": counts_gp,
            "fit full": counts_fit, "deep grad full": counts_deep,
            "deep fit full": counts_deep_fit, "mcmc hyper": counts_hyper,
            **runs_svgp, **runs_sparse, **runs_online, **runs_cg, **runs_pw, **runs_mk,
            **runs_dp, **runs_tp}
    launches = total_launches(runs)
    print(f"[launches] {json.dumps(runs)}", flush=True)
    need = {"logpdf full": ("gram_tile", "slab_factor"),
            "pred full": ("gram_tile", "slab_factor", "tri_inv_block"),
            "logpdf ragged": ("gram_tile", "slab_factor", "chol_inv_block"),
            "pred ragged": ("gram_tile", "slab_factor", "chol_inv_block", "tri_inv_block"),
            "grad full": ("gram_tile", "slab_factor", "tri_inv_block", "logpdf_contraction"),
            "grad ragged": ("chol_inv_block", "tri_inv_block", "logpdf_contraction"),
            "pred grad full": ("gram_tile", "slab_factor", "tri_inv_block", "gram_bwd"),
            "fit full": ("slab_factor", "tri_inv_block", "logpdf_contraction"),
            "deep grad full": ("gram_tile", "slab_factor", "tri_inv_block",
                               "logpdf_contraction"),
            "deep fit full": ("gram_tile", "slab_factor", "tri_inv_block",
                              "logpdf_contraction"),
            "mcmc hyper": HYPER_KERNELS,
            "svgp fit": tuple(SVGP_STEP_LAUNCHES),
            f"svgp M={SPARSE['m_big']}": ("gram_tile", "slab_factor", "tri_inv_block", "gram_bwd"),
            "sparse elbo grad": ("gram_tile", "gram_bwd"),
            "online extends": tuple(ONLINE_EXTEND_LAUNCHES),
            "cg logpdf": ("gram_matvec",), "cg grad": CG_KERNELS, "cg posterior": ("gram_matvec",),
            "cg mean": ("gram_tile",), "cg mean_and_var": ("gram_tile", "gram_matvec"),
            "cg grad forward": ("gram_tile", "gram_matvec"), "cg grad backward": CG_KERNELS,
            **{f"dp elbo step rank {r}": tuple(DP_STEP_LAUNCHES) for r in range(DP["world"])},
            **{f"dp nuts rank {r}": HYPER_KERNELS for r in range(DP["world"])},
            **{f"tp {p} rank {r}": tuple(TP_LAUNCHES[p]) for p in TP_LAUNCHES
               for r in range(DP["world"])},
            "tp 1-rank logpdf": ("gram_tile",),
            "pathwise setup": PATHWISE_KERNELS, "pathwise eval": ("gram_tile",),
            **MARKOV_DENSE_KERNELS}
    missing = {r: [k for k in ks if runs[r][k] == 0] for r, ks in need.items()}
    missing = {r: ks for r, ks in missing.items() if ks}
    if missing or set(bwd_in.calls) != {"sym", "plain", "transpose"} or not contr_in.calls:
        print(f"[launches] FAIL: a kernel of the path was not launched: {missing}", flush=True)
        ok = False

    with torch.no_grad():
        ref_full = oracle_f64(s2, ell, x, y, xs)
        ref_ragged = oracle_f64(s2r, ellr, xr, yr, xsr)
        ok_f = check_against_oracle(f"full N={N} M={M}", lp, mu, var, ref_full)
        ok_r = check_against_oracle(f"ragged N={N_RAGGED} M={M_RAGGED}", lp_r, mu_r,
                                    var_r, ref_ragged)
    shapes_ok = mu.shape == (M,) and var.shape == (M,) and mu_r.shape == (M_RAGGED,)
    ok_g = check_grads(f"grad full N={N}", g_full, grad_oracle_f64(s2, ell, x, y),
                       ref_full[3])
    ok_gr = check_grads(f"grad ragged N={N_RAGGED}", g_ragged,
                        grad_oracle_f64(s2r, ellr, xr, yr), ref_ragged[3])
    ok_gp = check_grads(f"pred grad full N={N} M={M}", g_pred,
                        grad_oracle_f64(s2, ell, x, y, xs), ref_full[3], budget=False)
    torch.cuda.empty_cache()
    ok_deep = deep_rg and check_deep_grads(f"deep grad full N={N}", g_deep,
                                           *deep_grad_oracle_f64(s2, ell, mlp, x, y))
    torch.cuda.empty_cache()
    ok = (ok and ok_f and ok_r and shapes_ok and ok_g and ok_gr and ok_gp and fit_ok
          and ok_deep and deep_fit_ok)

    # ---- each kernel against its plain version; times ---------------------
    with torch.no_grad():
        recs = kernel_checks(kernel, x, xs, post.data.L.detach(), slab_in.value,
                             block_in.value)
        recs.update(backward_kernel_checks(contr_in.calls[None], bwd_in.calls))
    recs["gram_matvec"] = checks_cg["gram_matvec cg"]  # timed at the [cg] path's own shapes
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

    def grad_once():
        return run_grad_path(theta, x, y)

    def pred_grad_once():
        return run_grad_path(theta, x, y, xs)

    grad_once()
    t0 = time.perf_counter()
    for _ in range(reps):
        grad_once()
    grad_s = (time.perf_counter() - t0) / reps
    pred_grad_once()
    t0 = time.perf_counter()
    for _ in range(3):
        pred_grad_once()
    pred_grad_s = (time.perf_counter() - t0) / 3
    print(f"[e2e] N={N} D={D} M={M} f32: logpdf {logpdf_s * 1e3:.3f} ms "
          f"({1.0 / logpdf_s:.3f} evals/s); pred {pred_s * 1e3:.3f} ms "
          f"({1.0 / pred_s:.3f} evals/s); grad {grad_s * 1e3:.3f} ms "
          f"({1.0 / grad_s:.3f} evals/s); pred grad {pred_grad_s * 1e3:.3f} ms "
          f"({1.0 / pred_grad_s:.3f} evals/s); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # the ragged width's prediction and gradient, which run the row-panel
    # trtri (36 diagonal blocks in one batched tri_inv_block launch each)
    def pred_ragged_once():
        p = agt.posterior(agt.GP(kernel_r)(xr, NOISE), yr)
        m_, v_ = p.mean_and_var(xsr)
        return float((m_.sum() + v_.sum()).detach())

    theta_r = caller_theta(s2r, ellr, dev, f32)
    ragged_s = {}
    for name, fn in (("pred", pred_ragged_once), ("grad", lambda: run_grad_path(theta_r, xr, yr))):
        fn()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        ragged_s[name] = (time.perf_counter() - t0) / 3
    print(f"[e2e] N={N_RAGGED} D={D} M={M_RAGGED} f32: pred {ragged_s['pred'] * 1e3:.3f} ms; "
          f"grad {ragged_s['grad'] * 1e3:.3f} ms", flush=True)
    profile_breakdown("logpdf", logpdf_once)
    profile_breakdown("pred", pred_once)
    profile_breakdown("grad", grad_once, top=14)
    profile_breakdown("pred grad", pred_grad_once, top=14)

    path_runs = {"svgp": runs_svgp, "sparse": runs_sparse, "online": runs_online,
                 "cg": runs_cg, "pathwise": runs_pw, "markov": runs_mk, "dp": runs_dp,
                 "tp": runs_tp}
    path_checks = {"svgp": checks_svgp, "sparse": checks_sparse, "online": checks_online,
                   "cg": checks_cg, "pathwise": checks_pw, "markov": checks_mk, "dp": checks_dp,
                   "tp": checks_tp}

    def slice_paths(name):
        # each later slice's path: its launches of the kernel (by run) and its
        # checks (with device and bound ms where timed at the path's shapes)
        out = {}
        for p, p_runs in path_runs.items():
            counts = {r: c[name] for r, c in p_runs.items() if c.get(name)}
            chk = {k: {f: v[f] for f in ("max_abs_err", "shape", "device_ms", "bound_ms")
                       if f in v}
                   for k, v in path_checks[p].items() if k.split(" ")[0] == name}
            if counts or chk:
                out[p] = {"launches": counts, "checks": chk}
        return out

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = recs[name]
        off_path = name in OFF_PATH
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": r["launches"] if off_path else launches[name],
            "path": None if off_path else "main",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r.get("device_ms"),
            "library_device_ms": r.get("library_device_ms"),
            **{k: r[k] for k in ("one_block_device_ms", "one_block_library_device_ms",
                                 "panel_shape", "panel_max_abs_err", "panel_device_ms",
                                 "panel_bound_ms")
               if k in r},
            **({"modes": {m_: {k: v for k, v in mr.items() if k not in ("ok", "tol")}
                          for m_, mr in r["modes"].items()}} if "modes" in r else {}),
            **({"mcmc_hyper": {"launches": counts_hyper[name],
                               "max_abs_err": hyper_checks[name]["max_abs_err"],
                               "shape": hyper_checks[name]["shape"]}}
               if name in hyper_checks else {}),
            "paths": slice_paths(name),
        })
    print(f"[main] the main path, its checks and timings took {time.perf_counter() - t_main:.1f} "
          f"s; the whole script took {time.perf_counter() - t_script:.1f} s", flush=True)
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
