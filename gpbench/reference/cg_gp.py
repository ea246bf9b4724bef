"""Plain reference of the BBMM estimate of the exact GP's log marginal
likelihood (Gardner et al. 2018, "GPyTorch: Blackbox Matrix-Matrix
Gaussian Process Inference with GPU Acceleration", §3-4) and of its
gradient, written apart from the program: a dense gram, the preconditioned
CG/Lanczos recurrence on it, stochastic Lanczos quadrature, and autograd
through the gram.

The estimator is a function of random draws, and the reference is handed
those the program drew (``inputs``): the probe normals u (k × p) and w
(n × p), and the preconditioner's pivot order at each step. From them:

- the rank-k factor L = K[:, piv] chol(K[piv, piv])⁻ᵀ, which is what the
  greedy pivoted Cholesky computes once its pivots are fixed;
- the probes z = L u + √noise · w, with covariance P = LLᵀ + noise·I;
- ``max_iters`` steps of preconditioned CG on all 1 + p columns at once,
  each column frozen once its residual norm falls to ``tol`` of its
  right-hand side's (or its curvature pᵀAp is not positive), recording
  the CG coefficients; the solution α of the data column, U of the probes;
- log|A| = log|P| + mean_i zᵢᵀP⁻¹zᵢ · e₁ᵀ log(Tᵢ) e₁, Tᵢ the Lanczos
  tridiagonal of probe i from its CG coefficients (a frozen step adds an
  identity block, as if its Lanczos process had ended there);
- the loss −log p = ½(n log 2π + log|A| + yᵀα);
- its gradient as BBMM takes it: ∂/∂θ of Σᵢⱼ (Lft Rgtᵀ)ᵢⱼ Aᵢⱼ(θ) with
  Lft = [½α, −U/(2p)] and Rgt = [α, P⁻¹Z] held fixed (the solves and the
  probes take no gradient), by autograd through the gram, one row panel
  at a time.

Departures from the program's arithmetic: the gram's squared distances
come from the norms (``exact_gp.sqdist``), the program's from the
differences; the factor comes from the given pivots by one Cholesky and
a triangular solve, the program's by k rank-1 steps; each step's matvec is
one product with the dense gram, the program's rebuilds it panel by panel;
the gradient's panels are 2048 rows, the program's ``panel``. The CG
recurrence, its freezing rule, the quadrature and the gradient's formula
are the program's. In float64 the sums run in another order than the
program's float32 ones, so a column can freeze a step sooner or later.
"""

from __future__ import annotations

import contextlib
import math

import torch

from gpbench.numerics import F64, Prec
from gpbench.reference import _adam as adam
from gpbench.reference.exact_gp import kernel, raw_start, softplus, sqdist

_LOG_2PI = math.log(2.0 * math.pi)
_GRAD_PANEL = 2048


@contextlib.contextmanager
def _ieee_f32():
    """TF32 off for every product the reference takes outside ``Prec.mm``."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _tolerance(cfg: dict) -> float:
    """The solver's relative residual tolerance: the configuration's, or
    √eps of its dtype, as the program takes it."""
    tol = cfg["cg"].get("tol")
    return tol if tol is not None else torch.finfo(getattr(torch, cfg["dtype"])).eps ** 0.5


def _gram(cfg, x, s2, ell, prec: Prec):
    """K(x, x) in row panels (so that the reference's largest temporary is
    a panel, not another n × n array)."""
    n = x.shape[0]
    K = torch.empty((n, n), dtype=x.dtype, device=x.device)
    for r in range(0, n, _GRAD_PANEL):
        K[r:r + _GRAD_PANEL] = kernel(cfg["kernel"], sqdist(x[r:r + _GRAD_PANEL], x, prec),
                                      s2, ell)
    return K


def _preconditioner(K, noise, pivots, prec: Prec):
    """(L, P⁻¹-apply, log|P|) for P = LLᵀ + noise·I, L from the pivots of
    the gram K (without the noise)."""
    n = K.shape[0]
    rows = K[pivots]
    L = torch.linalg.solve_triangular(torch.linalg.cholesky(rows[:, pivots]), rows,
                                      upper=False).T  # K[:, piv] Lpp⁻ᵀ
    k = L.shape[1]
    M = torch.eye(k, dtype=K.dtype, device=K.device) + prec.mm(L.T, L) / noise
    LM = torch.linalg.cholesky(M)

    def solve(V):  # P⁻¹V = (V − L M⁻¹ LᵀV / noise) / noise
        W = torch.cholesky_solve(prec.mm(L.T, V), LM) / noise
        return (V - prec.mm(L, W)) / noise

    logdet = 2.0 * torch.log(torch.diagonal(LM)).sum() + n * torch.log(noise)
    return L, solve, logdet


def dense_matvec(A, V, prec: Prec):
    """One solver step's product of the dense A = K + noise·I with V."""
    return prec.mm(A, V)


def mbcg(matvec, B, psolve, max_iters: int, tol: float):
    """Preconditioned CG on the columns of B at once, each frozen once its
    residual falls to ``tol`` of its right-hand side (or its curvature is
    not positive). Returns (X, α, β, active), the coefficients (t, q)."""
    rs0 = (B * B).sum(0)
    R, P = B, psolve(B)
    rz = (R * P).sum(0)
    X = torch.zeros_like(B)
    active = rs0 > 0
    alphas, betas, actives = [], [], []
    for _ in range(max_iters):
        KP = matvec(P)
        pKp = (P * KP).sum(0)
        active = active & (pKp > 0)
        alpha = torch.where(active, rz / torch.where(pKp > 0, pKp, 1.0), 0.0)
        X = X + alpha * P
        R = R - alpha * KP
        Z = psolve(R)
        rz_new = (R * Z).sum(0)
        beta = torch.where(active, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        P = torch.where(active, Z + beta * P, P)
        alphas.append(alpha)
        betas.append(beta)
        actives.append(active)
        rz = rz_new
        active = active & ((R * R).sum(0) > tol * tol * rs0)
    return X, torch.stack(alphas), torch.stack(betas), torch.stack(actives)


def slq(alphas, betas, actives, norms2):
    """mean_i norms2_i · e₁ᵀ log(T_i) e₁, T_i the Lanczos tridiagonal of
    column i: T[j, j] = 1/αⱼ + βⱼ₋₁/αⱼ₋₁, T[j, j+1] = √βⱼ/αⱼ over the
    column's active steps, an identity block over its frozen ones."""
    total = 0.0
    for i in range(alphas.shape[1]):
        a, b, act = alphas[:, i], betas[:, i], actives[:, i]
        t = int(act.sum())  # the active steps come first
        inv = 1.0 / a[:t]
        diag = inv.clone()
        diag[1:] += b[:t - 1] * inv[:-1]
        off = torch.sqrt(torch.clamp(b[:t - 1], min=0.0)) * inv[:-1]
        T = torch.diag(diag) + torch.diag(off, 1) + torch.diag(off, -1)
        w, V = torch.linalg.eigh(T)
        w = torch.clamp(w, min=torch.finfo(w.dtype).tiny)  # positive in exact arithmetic
        total = total + norms2[i] * (V[0] ** 2 * torch.log(w)).sum()
    return total / alphas.shape[1]


def estimate(cfg: dict, raw: dict, x, y, normals: dict, pivots, prec: Prec = F64):
    """(−log p estimate, its BBMM gradient by raw leaf) at the raw leaves
    {ell, noise, s2}, on the given probe normals and pivots."""
    c = cfg["cg"]
    x, y = prec.cast(x), prec.cast(y)
    u, w = prec.cast(normals["u"]), prec.cast(normals["w"])
    s2, ell, noise = (softplus(raw[k].detach()) for k in ("s2", "ell", "noise"))
    n, p = x.shape[0], w.shape[1]
    A = _gram(cfg, x, s2, ell, prec)
    L, psolve, logdet_P = _preconditioner(A, noise, pivots.to(A.device), prec)
    A.diagonal().add_(noise)
    Z = prec.mm(L, u) + torch.sqrt(noise) * w
    X, alphas, betas, actives = mbcg(lambda V: dense_matvec(A, V, prec),
                                     torch.cat([y[:, None], Z], 1), psolve, c["max_iters"],
                                     _tolerance(cfg))
    del A
    alpha, U = X[:, 0], X[:, 1:]
    PinvZ = psolve(Z)
    logdet = logdet_P + slq(alphas[:, 1:], betas[:, 1:], actives[:, 1:], (Z * PinvZ).sum(0))
    loss = 0.5 * (n * _LOG_2PI + logdet + y @ alpha)
    # the surrogate's gradient: Σ (Lft Rgtᵀ) ⊙ A, its panels one at a time (the
    # cotangent formed first: ``Prec.mm`` takes no gradient)
    Lft = torch.cat([0.5 * alpha[:, None], -U / (2.0 * p)], 1)
    Rgt = torch.cat([alpha[:, None], PinvZ], 1)
    leaves = {k: raw[k].detach().to(x.dtype).requires_grad_() for k in ("s2", "ell", "noise")}
    grads = dict.fromkeys(leaves, 0.0)
    for r in range(0, n, _GRAD_PANEL):
        with torch.enable_grad():
            th = {k: softplus(v) for k, v in leaves.items()}
            Kp = kernel(cfg["kernel"], sqdist(x[r:r + _GRAD_PANEL], x, prec), th["s2"],
                        th["ell"])
            s = (Kp * prec.mm(Lft[r:r + _GRAD_PANEL], Rgt.T)).sum()
            if r == 0:
                s = s + th["noise"] * (Lft * Rgt).sum()
            g = torch.autograd.grad(s, list(leaves.values()), allow_unused=True)
        for k, gk in zip(leaves, g):
            if gk is not None:
                grads[k] = grads[k] - gk  # the loss is −log p
    return loss, grads


def train_steps(cfg: dict, traffic: dict, inputs: dict, prec: Prec = F64) -> dict:
    """Follow the program's first ``steps`` Adam steps from the same start on
    the same data, probes and pivots (``inputs``: x, y, steps, normals,
    pivots (one a step), and start or raw)."""
    raw0 = raw_start(inputs, ("s2", "ell", "noise"), prec)
    pivots = iter(inputs["pivots"])

    def loss(raw):
        # the estimate and its gradient, as a value whose autograd gradient
        # in the raw leaves is the BBMM gradient
        val, g = estimate(cfg, raw, inputs["x"], inputs["y"], inputs["normals"], next(pivots),
                          prec)
        return val + sum((g[k] * (raw[k] - raw[k].detach())).sum() for k in g)

    with _ieee_f32():
        return adam.follow(loss, raw0, inputs["steps"], traffic["learning_rate"])
