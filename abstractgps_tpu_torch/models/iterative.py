"""Iterative (matrix-free) exact-GP inference: batched CG + SLQ logdet.

Counterpart of the JAX package's ``models/iterative.py``, in the style of
GPyTorch's BBMM (Gardner et al. 2018, arXiv:1809.11165) and stochastic
Lanczos quadrature (Dong et al. 2017, arXiv:1711.03481):

- every CG step is one gram matvec: one GEMM against the dense gram when
  N ≤ ``max_dense_n``, else the gram formed on the fly
  (``ops.matvec.make_gram_matvec``): for an isotropic kernel under
  scalings and transforms one launch of the fused kernel ``gram_matvec``
  on the card, which never stores K; for any other kernel the panels
  rebuilt one by one (``ops.matvec.gram_matvec``, one ``gram_tile`` launch
  a panel), so memory stays O(panel·N);
- the solver is batched (mBCG): the data solve and all probe solves share
  every matvec, and it stops once every column has frozen (``max_iters`` is
  a cap, as in GPyTorch's ``linear_cg``); on the card it learns that from
  a flag copied to pinned host memory behind an event it polls, so the loop
  makes no blocking host read;
- ``logdet(K+Σ)`` comes from the Lanczos tridiagonals that the CG
  coefficients give for free, via batched ``eigh`` of t×t matrices;
- the gradient is the BBMM rank-(q+p) cotangent
  ``½ Σⱼ ḡⱼ αⱼαⱼᵀ − (Σḡ)/(2p) · U (P⁻¹Z)ᵀ`` (α = K⁻¹δ, U = K⁻¹Z),
  contracted against the gram one recomputed panel at a time (``_CGLogpdf``),
  so the backward never holds more than one panel either; on the card each
  panel's VJP is ``gram_bwd`` (plain for the panel's rows, transposed for
  the columns).

Spans (``utils.profiling``): ``model.cg_logpdf`` around ``cg_logpdf``;
``ops.cg.precond`` around the pivoted Cholesky, the Woodbury sampler and
solver; ``ops.cg.solve`` around one ``mbcg``, ``ops.cg.matvec`` around each
of its steps' matvec (not each panel); ``ops.cg.slq`` around the
quadrature; ``ops.cg_backward`` around a backward's panel contraction.
``LIBRARY_CALLS["cg_matvec"]`` counts the solver's matvecs (and
``"cg_fused_matvec"``, at ``ops.matvec``, those of the fused route),
``"cg_skipped_matvec"`` the steps under ``max_iters`` it did not run, and,
while a ``recording()`` is open, ``"cg_converged_matvec"`` the steps it ran
with no column of the batch active (the exit's lag on the card).

The CG iterations record no autograd graph. ``cg_logpdf`` is differentiable
through its own backward, and so are the CG posterior's predictions: every
solve X = A⁻¹B is ``_CGSolve``, whose backward is implicit (one more mBCG
solve for B̄ = A⁻¹X̄, then −B̄Xᵀ contracted with ∂A through the same panel
VJP as the logpdf's backward), so y, x, x*, the noise and the kernel's
hyperparameters all get gradients.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.base import hyperparameters, leaf_hyperparameters
from ..ops.blocked_chol import _param_grads
from ..ops.distance import as_inputs, as_tensor
from ..ops.draws import as_draws
from ..ops.matvec import _pad_rows, make_gram_matvec
from ..ops.noise import DenseNoise
from ..ops.pivchol import pivoted_cholesky, woodbury_preconditioner
from ..ops.precision import full_f32, precise
from ..utils.profiling import LIBRARY_CALLS, is_recording, span
from .gp import GP, AbstractGP

__all__ = [
    "mbcg",
    "slq_logdet",
    "cg_logpdf",
    "CGInference",
    "CGPosteriorGP",
]

_LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Batched conjugate gradients with Lanczos coefficient capture (mBCG).
# ---------------------------------------------------------------------------


class _FrozenWatch:
    """Whether a finished solver step left every column frozen, learnt
    without blocking. On the card each posted mask's ``any()`` is copied to
    a pinned host slot behind an event, and ``frozen()`` reads only the
    slots whose events have completed; the steps launched meanwhile are the
    no-ops the fixed-trip loop would have run. Elsewhere it reads the flag
    at once."""

    def __init__(self, active: torch.Tensor, steps: int):
        self.done, self.posted, self.pending = False, 0, []
        self.flags = None
        if active.is_cuda:
            self.flags = torch.empty(steps + 1, dtype=torch.bool, pin_memory=True)
            self.seen = self.flags.numpy()
            self.stream = torch.cuda.current_stream(active.device)
        self.post(active)

    def post(self, active: torch.Tensor) -> None:
        if self.flags is None:
            self.done = not bool(active.any())
            return
        self.flags[self.posted].copy_(active.any(), non_blocking=True)
        event = torch.cuda.Event()
        event.record(self.stream)
        self.pending.append((self.posted, event))
        self.posted += 1

    def frozen(self) -> bool:
        while not self.done and self.pending and self.pending[0][1].query():
            slot, _ = self.pending.pop(0)
            self.done = not self.seen[slot]
        return self.done


@torch.no_grad()
def mbcg(matvec, B: torch.Tensor, *, max_iters: int, tol: float | None = None,
         precond=None):
    """Solve ``A X = B`` column-batched, recording the CG recurrence.

    ``matvec(V)`` applies the SPD operator to an (n, q) block; ``precond``
    (optional) applies ``P⁻¹`` (the recorded recurrence then tridiagonalises
    ``P^{-1/2} A P^{-1/2}``). A column whose residual falls to ``tol``
    (relative, default ``sqrt(eps)`` of B's dtype) is frozen, and so is one
    that breaks down (``pKp ≤ 0``): its later steps record α = β = 0, so the
    Lanczos tridiagonal decouples into [T_active ⊕ I] exactly. Once every
    column has frozen the later steps change nothing, so the loop stops
    there (on the card a step or a few later, ``_FrozenWatch``) and at
    ``max_iters`` steps at most; the coefficients of the steps not run are
    those steps' α = β = 0, inactive, so every output is the fixed-trip
    loop's.

    Returns ``(X, (alphas, betas, actives))``, the coefficients (max_iters, q).
    """
    with span("ops.cg.solve"):
        psolve = precond if precond is not None else (lambda v: v)
        if tol is None:
            tol = torch.finfo(B.dtype).eps ** 0.5
        rs0 = torch.sum(B * B, dim=0)
        Z0 = psolve(B)
        rz = torch.sum(B * Z0, dim=0)
        X, R, P, active = torch.zeros_like(B), B, Z0, rs0 > 0
        thresh = (tol * tol) * rs0
        zero, one = B.new_zeros(()), B.new_ones(())
        alphas, betas, actives = [], [], []
        watch = _FrozenWatch(active, max_iters)
        for _ in range(max_iters):
            if watch.frozen():
                break
            LIBRARY_CALLS["cg_matvec"] += 1
            with span("ops.cg.matvec"):
                KP = matvec(P)
            pKp = torch.sum(P * KP, dim=0)
            active = active & (pKp > 0)  # breakdown → freeze, α/β = 0
            alpha = torch.where(active, rz / torch.where(pKp > 0, pKp, one), zero)
            X = X + alpha[None, :] * P
            R = R - alpha[None, :] * KP
            Z = psolve(R)
            rz_new = torch.sum(R * Z, dim=0)
            rs_new = torch.sum(R * R, dim=0)
            beta = torch.where(active, rz_new / torch.where(rz != 0, rz, one), zero)
            P = torch.where(active[None, :], Z + beta[None, :] * P, P)
            alphas.append(alpha)
            betas.append(beta)
            actives.append(active)
            rz = rz_new
            active = active & (rs_new > thresh)
            watch.post(active)
        ran = len(alphas)
        LIBRARY_CALLS["cg_skipped_matvec"] += max_iters - ran
        if ran and is_recording():  # a host read: the steps run with no column active
            LIBRARY_CALLS["cg_converged_matvec"] += int(
                (~torch.stack(actives).any(dim=1)).sum())
        nil = B.new_zeros(B.shape[1])
        alphas += [nil] * (max_iters - ran)
        betas += [nil] * (max_iters - ran)
        actives += [nil.bool()] * (max_iters - ran)
    return X, (torch.stack(alphas), torch.stack(betas), torch.stack(actives))


def _lanczos_tridiag(alphas, betas, actives):
    """(t, q) CG coefficients → (q, t, t) Lanczos tridiagonal matrices.

    T[j,j] = 1/αⱼ + βⱼ₋₁/αⱼ₋₁ ; T[j,j+1] = √βⱼ/αⱼ. Frozen steps become a
    decoupled identity block (diag 1, boundary off-diagonal 0), which adds
    exactly zero to e₁ᵀlog(T)e₁.
    """
    a, b, act = alphas.T, betas.T, actives.T  # (q, t)
    zero = a.new_zeros(())
    inv_a = torch.where(act, 1.0 / torch.where(a != 0, a, a.new_ones(())), zero)
    prev = torch.nn.functional.pad((b * inv_a)[:, :-1], (1, 0))
    diag = torch.where(act, inv_a + prev, a.new_ones(()))
    off = torch.where(act[:, 1:], (torch.sqrt(torch.clamp(b, min=0.0)) * inv_a)[:, :-1], zero)
    return torch.diag_embed(diag) + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)


def slq_logdet(alphas, betas, actives, norms2) -> torch.Tensor:
    """Stochastic Lanczos quadrature estimate of ``logdet(A)``:
    ``mean_i ‖z_i‖² · e₁ᵀ log(T_i) e₁`` (Dong et al. 2017), the T_i from
    the CG recurrence."""
    with span("ops.cg.slq"):
        T = _lanczos_tridiag(alphas, betas, actives)
        w, V = torch.linalg.eigh(T)
        w = torch.clamp(w, min=torch.finfo(T.dtype).tiny)  # PD in exact arithmetic
        e1 = V[:, 0, :]  # first component of each eigenvector, (q, t)
        return torch.mean(torch.sum(e1 * e1 * torch.log(w), dim=-1) * norms2)


# ---------------------------------------------------------------------------
# Matrix-free logpdf with the BBMM low-rank gradient.
# ---------------------------------------------------------------------------


def _contract_gram_vjp(kernel, x, params, Lft, Rgt, *, panel: int, need_x: bool):
    """(x̄ or None, {id(param): bar}) of ``Σ_{ij} (Lft Rgtᵀ)_{ij} K(x,x)_{ij}``,
    the gram rebuilt one row panel at a time and differentiated at once
    (the counterpart of the JAX package's ``jax.checkpoint``ed scan): never
    more than one (panel, n) block and its cotangent alive. The
    hyperparameters are differentiated through leaf aliases
    (``leaf_hyperparameters``), so the caller's graph is not entered."""
    wanted = [p for p in params if p.requires_grad]
    xbar, bars = None, [None] * len(wanted)
    if not (need_x or wanted):
        return xbar, {}
    with span("ops.cg_backward"), torch.enable_grad(), leaf_hyperparameters(kernel) as alias, \
            full_f32():
        x_ = as_inputs(x).detach().requires_grad_(need_x)
        wrt = ([x_] if need_x else []) + [alias.get(id(p), p) for p in wanted]
        xp = _pad_rows(x_, panel)
        Lp = _pad_rows(Lft, panel)  # zero rows null out padded-x kernel rows
        for r0 in range(0, xp.shape[0], panel):
            Kp = kernel.cross(xp[r0:r0 + panel], x_)  # (panel, n), transforms included
            s = torch.sum(Lp[r0:r0 + panel] * (Kp @ Rgt))
            grads = list(torch.autograd.grad(s, wrt, allow_unused=True))
            if need_x:
                g = grads.pop(0)
                xbar = g if xbar is None else xbar + g
            bars = [b if g is None else (g if b is None else b + g)
                    for b, g in zip(bars, grads)]
    return xbar, {id(p): b for p, b in zip(wanted, bars) if b is not None}


def _make_precond(kernel, x, noise_diag, rank: int, Lk=None):
    """(P⁻¹-apply, logdet P) for ``P = pivchol_k(K) + Σ``, or identity.
    ``Lk`` (the rank-k pivoted-Cholesky factor) may be passed in when the
    caller already built it."""
    if rank <= 0:
        return None, noise_diag.new_zeros(())
    with span("ops.cg.precond"):
        if Lk is None:
            Lk = pivoted_cholesky(kernel, x, rank)
        solve, logdet_P, _ = woodbury_preconditioner(Lk, noise_diag)
    return solve, logdet_P


def _cg_logpdf_impl(kernel, x, noise_diag, delta, probes, Lk,
                    max_iters, tol, panel, max_dense_n, precond_rank):
    """Forward pass. With preconditioning, ``probes`` were drawn with
    covariance P from the same ``Lk``, and the recorded recurrence
    tridiagonalises P^{-1/2}(K+Σ)P^{-1/2}, so logdet(K+Σ) = logdet P + SLQ
    (BBMM §3.2). Returns ``(out, α, U, P⁻¹Z)``."""
    mv = make_gram_matvec(kernel, x, noise_diag, panel=panel, max_dense_n=max_dense_n)
    psolve, logdet_P = _make_precond(kernel, x, noise_diag, precond_rank, Lk=Lk)
    vec = delta.ndim == 1
    Dm = delta[:, None] if vec else delta
    k = Dm.shape[1]
    Z = probes.to(Dm.dtype)
    B = torch.cat([Dm, Z], dim=1)
    X, (alphas, betas, actives) = mbcg(mv, B, max_iters=max_iters, tol=tol, precond=psolve)
    alpha, U = X[:, :k], X[:, k:]
    quad = torch.sum(Dm * alpha, dim=0)
    PinvZ = Z if psolve is None else psolve(Z)
    norms2 = torch.sum(probes * PinvZ, dim=0)  # ‖z‖²_{P⁻¹} (= ‖z‖² unpreconditioned)
    logdet = logdet_P + slq_logdet(alphas[:, k:], betas[:, k:], actives[:, k:], norms2)
    n = x.shape[0]
    out = -0.5 * (n * _LOG_2PI + logdet + quad)
    return (out[0] if vec else out), alpha, U, PinvZ


class _CGLogpdf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, x, noise_diag, delta, probes, Lk, opts, *params):
        out, alpha, U, PinvZ = _cg_logpdf_impl(kernel, x, noise_diag, delta, probes, Lk,
                                               *opts)
        ctx.kernel, ctx.panel, ctx.vec = kernel, opts[2], delta.ndim == 1
        ctx.save_for_backward(x, PinvZ, alpha, U)
        return out

    @staticmethod
    def backward(ctx, gbar):
        x, PinvZ, alpha, U = ctx.saved_tensors
        params = hyperparameters(ctx.kernel)
        g = (gbar.reshape(1) if ctx.vec else gbar).to(alpha.dtype)
        p = PinvZ.shape[1]
        gsum = torch.sum(g)
        # ∂logpdf/∂K = ½(Σⱼ ḡⱼ αⱼαⱼᵀ − (Σḡ)·K⁻¹); with z ~ N(0, P) and
        # u = K⁻¹z, E[u (P⁻¹z)ᵀ] = K⁻¹ P P⁻¹ = K⁻¹ — so the Hutchinson factor
        # pairs U with P⁻¹Z (= Z itself when unpreconditioned).
        Lft = torch.cat([0.5 * alpha * g[None, :], (-gsum / (2.0 * p)) * U], dim=1)
        Rgt = torch.cat([alpha, PinvZ.to(alpha.dtype)], dim=1)
        xbar, bars = _contract_gram_vjp(ctx.kernel, x, params, Lft, Rgt, panel=ctx.panel,
                                        need_x=ctx.needs_input_grad[1])
        ndbar = torch.sum(Lft * Rgt, dim=1)  # diag of the gram cotangent
        dbar = -(alpha * g[None, :])
        dbar = dbar[:, 0] if ctx.vec else dbar
        if xbar is not None:
            xbar = xbar.reshape(x.shape)
        return (None, xbar, ndbar, dbar, None, None, None, *_param_grads(params, bars))


def _cg_solve(kernel, x, noise_diag, B, Lk, opts):
    """X = A⁻¹B by mBCG, A = K(x, x) + diag(noise); ``opts`` = (max_iters,
    tol, panel, max_dense_n, precond_rank)."""
    max_iters, tol, panel, max_dense_n, precond_rank = opts
    mv = make_gram_matvec(kernel, x, noise_diag, panel=panel, max_dense_n=max_dense_n)
    psolve, _ = _make_precond(kernel, x, noise_diag, precond_rank, Lk=Lk)
    X, _ = mbcg(mv, B, max_iters=max_iters, tol=tol, precond=psolve)
    return X


class _CGSolve(torch.autograd.Function):
    """X = A⁻¹B with an implicit backward: B̄ = A⁻¹X̄ (one more mBCG solve
    with the same preconditioner), and since ∂X = −A⁻¹(∂A)X, the gram gets
    the cotangent −B̄Xᵀ (contracted panel by panel, ``_contract_gram_vjp``)
    and the noise its diagonal −Σ_cols B̄ ⊙ X. The preconditioner factor
    ``Lk`` takes no gradient: the solution does not depend on it."""

    @staticmethod
    def forward(ctx, kernel, x, noise_diag, B, Lk, opts, *params):
        if Lk is None and opts[4] > 0:
            with span("ops.cg.precond"):  # built once, for the backward too
                Lk = pivoted_cholesky(kernel, x, opts[4])
        X = _cg_solve(kernel, x, noise_diag, B, Lk, opts)
        ctx.kernel, ctx.opts, ctx.Lk = kernel, opts, Lk
        ctx.save_for_backward(x, noise_diag, X)
        return X

    @staticmethod
    def backward(ctx, Xbar):
        x, noise_diag, X = ctx.saved_tensors
        X = X.detach()  # a saved output unpacks with this node as its grad_fn
        params = hyperparameters(ctx.kernel)
        Bbar = _cg_solve(ctx.kernel, x, noise_diag, Xbar.to(X.dtype), ctx.Lk, ctx.opts)
        xbar, bars = _contract_gram_vjp(ctx.kernel, x, params, -Bbar, X, panel=ctx.opts[2],
                                        need_x=ctx.needs_input_grad[1])
        ndbar = -torch.sum(Bbar * X, dim=1) if ctx.needs_input_grad[2] else None
        if xbar is not None:
            xbar = xbar.reshape(x.shape)
        return (None, xbar, ndbar, Bbar, None, None, *_param_grads(params, bars))


def _require_kernel_prior(fx):
    """CG backend scope: kernel-based GP prior + diagonal-structured noise.
    Correlated (DenseNoise) observation noise is rejected, not dropped."""
    if not isinstance(fx.f, GP):
        raise NotImplementedError(
            "the CG backend requires a kernel-based GP prior; got "
            f"{type(fx.f).__name__}"
        )
    if isinstance(fx.noise, DenseNoise):
        raise NotImplementedError(
            "the CG backend supports isotropic/diagonal noise only; "
            "DenseNoise would be silently mis-handled"
        )
    return fx.f.kernel, fx.noise.diag().to(fx.x.dtype)


@precise
def cg_logpdf(fx, y, draws=None, *, num_probes: int = 32, max_iters: int = 256,
              tol: float | None = None, panel: int = 1024, max_dense_n: int = 8192,
              precond_rank: int = 0) -> torch.Tensor:
    """Matrix-free estimate of ``logpdf(fx, y)``.

    Solves are exact to ``tol`` (default: sqrt(eps) of the data dtype); the
    logdet is the SLQ estimator over ``num_probes`` probes. ``precond_rank``
    > 0 enables the rank-k pivoted-Cholesky/Woodbury preconditioner, with
    probes drawn ~ N(0, P) and logdet split as logdet P + SLQ; the rank-k
    factor is built once here. ``draws`` is a ``torch.Generator``, an int
    seed (None: 0) or a draws object (``ops.draws``), for the probes:
    Rademacher (n, p), or the Woodbury sampler's normals. ``y`` is (n,) →
    scalar or (n, q) → (q,) column-wise. Differentiable in the kernel's
    hyperparameters, x, the noise and y.
    """
    with span("model.cg_logpdf"):
        kernel, nd = _require_kernel_prior(fx)
        y = as_tensor(y)
        draws = as_draws(draws, fx.x.device)
        m = fx.f.mean(fx.x)
        delta = y - (m if y.ndim == 1 else m[:, None])
        n = fx.x.shape[0]
        with torch.no_grad():
            if precond_rank > 0:
                with span("ops.cg.precond"):
                    Lk = pivoted_cholesky(kernel, fx.x, precond_rank)
                    _, _, sample = woodbury_preconditioner(Lk, nd.detach())
                    probes = sample(draws, num_probes).to(delta.dtype)
            else:
                Lk = delta.new_zeros((n, 0))
                probes = draws.rademacher((n, num_probes), delta.dtype, delta.device)
        if tol is None:
            tol = torch.finfo(delta.dtype).eps ** 0.5
        opts = (max_iters, tol, panel, max_dense_n, precond_rank)
        return _CGLogpdf.apply(kernel, fx.x, nd, delta, probes, Lk, opts,
                               *hyperparameters(kernel))


# ---------------------------------------------------------------------------
# CG posterior — a PosteriorGP-equivalent AbstractGP with a matrix-free cache.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class CGPosteriorGP(AbstractGP):
    """Exact GPR posterior whose cache is ``α = (K+Σ)⁻¹(y−m)`` from CG.

    The predictive equations of the exact posterior
    (src/exact_gpr_posterior.jl:60-90) with every whitening solve replaced
    by a CG solve against the train-train operator; nothing N×N is
    factorised or stored. Every solve is differentiable (``_CGSolve``).
    """

    prior: GP
    x: torch.Tensor
    noise_diag: torch.Tensor
    alpha: torch.Tensor
    Lk: torch.Tensor | None = None  # cached rank-k pivoted-Cholesky preconditioner
    max_iters: int = 256
    tol: float | None = None
    panel: int = 1024
    max_dense_n: int = 8192
    precond_rank: int = 0

    def _solve(self, B: torch.Tensor) -> torch.Tensor:
        # reuse the pivoted-Cholesky factor CGInference.posterior built
        kernel = self.prior.kernel
        opts = (self.max_iters, self.tol, self.panel, self.max_dense_n, self.precond_rank)
        return _CGSolve.apply(kernel, self.x, self.noise_diag, B, self.Lk, opts,
                              *hyperparameters(kernel))

    def _cross(self, xs) -> torch.Tensor:
        """K(train, xs) — (N, M)."""
        return self.prior.kernel.cross(as_inputs(self.x), as_inputs(xs))

    @precise
    def mean(self, xs):
        # m(x*) + K*ₓᵀ α (src/exact_gpr_posterior.jl:60-62)
        return self.prior.mean(xs) + self._cross(xs).T @ self.alpha

    @precise
    def cov(self, xs, zs=None):
        C1 = self._cross(xs)
        if zs is None:
            return self.prior.cov(xs) - C1.T @ self._solve(C1)
        C2 = self._cross(zs)
        return self.prior.cov(xs, zs) - C1.T @ self._solve(C2)

    @precise
    def var(self, xs):
        C1 = self._cross(xs)
        return self.prior.var(xs) - torch.sum(C1 * self._solve(C1), dim=0)

    @precise
    def mean_and_cov(self, xs):
        C1 = self._cross(xs)
        W = self._solve(C1)
        m = self.prior.mean(xs) + C1.T @ self.alpha
        return m, self.prior.cov(xs) - C1.T @ W

    @precise
    def mean_and_var(self, xs):
        C1 = self._cross(xs)
        W = self._solve(C1)
        m = self.prior.mean(xs) + C1.T @ self.alpha
        return m, self.prior.var(xs) - torch.sum(C1 * W, dim=0)


@dataclasses.dataclass(frozen=True)
class CGInference:
    """Iterative-inference marker, dual to ``ExactInference``/``VFE``/``DTC``:
    ``posterior(CGInference(), fx, y)`` → CGPosteriorGP;
    ``approx_log_evidence(CGInference(), fx, y)`` → the SLQ-estimated
    logpdf, its probes from a generator on the data's device seeded with
    ``probe_seed``."""

    num_probes: int = 32
    max_iters: int = 256
    tol: float | None = None
    panel: int = 1024
    max_dense_n: int = 8192
    precond_rank: int = 64
    probe_seed: int = 0

    def posterior(self, fx, y) -> CGPosteriorGP:
        kernel, nd = _require_kernel_prior(fx)
        delta = as_tensor(y) - fx.f.mean(fx.x)
        Lk = None
        if self.precond_rank > 0:
            with torch.no_grad(), span("ops.cg.precond"):
                Lk = pivoted_cholesky(kernel, fx.x, self.precond_rank)
        opts = (self.max_iters, self.tol, self.panel, self.max_dense_n, self.precond_rank)
        X = _CGSolve.apply(kernel, fx.x, nd, delta[:, None], Lk, opts, *hyperparameters(kernel))
        return CGPosteriorGP(
            prior=fx.f, x=fx.x, noise_diag=nd, alpha=X[:, 0], Lk=Lk,
            max_iters=self.max_iters, tol=self.tol, panel=self.panel,
            max_dense_n=self.max_dense_n, precond_rank=self.precond_rank,
        )

    def approx_log_evidence(self, fx, y) -> torch.Tensor:
        return cg_logpdf(
            fx, y, self.probe_seed, num_probes=self.num_probes,
            max_iters=self.max_iters, tol=self.tol, panel=self.panel,
            max_dense_n=self.max_dense_n, precond_rank=self.precond_rank,
        )
