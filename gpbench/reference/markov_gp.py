"""Plain reference of the temporal GP's negative log marginal likelihood:
σ²·Matérn-3/2(ℓ) on sorted 1-D timestamps with isotropic noise, computed
by Kalman filtering its state-space form, and its gradient by autograd;
written from the papers, apart from the program.

The model (Hartikainen & Särkkä 2010, "Kalman filtering and smoothing
solutions to temporal Gaussian process regression models", §3): the
Matérn-3/2 process is the first entry of the state s = (f, f′) of the SDE
ds = F s dt + L dβ with λ = √3/ℓ,

    F = [[0, 1], [−λ², −2λ]],   P∞ = diag(σ², λ²σ²),   H = [1, 0],

so between timestamps Δt apart, with x = λΔt,

    A = exp(FΔt) = e^{−x} [[1 + x, Δt], [−λx, 1 − x]],
    Q = P∞ − A P∞ Aᵀ, entry by entry (u = 2x):
      Q₁₁ = σ²   (1 − e^{−u}(1 + u + u²/2)),
      Q₁₂ = σ²λ  (u²/2) e^{−u},
      Q₂₂ = σ²λ² (1 − e^{−u}(1 − u + u²/2)).

Q₁₁ and Q₂₂ are differences of numbers near 1 when Δt is small: Q₁₁ is
(4/3)x³σ² against terms of size σ². Taken as written, each carries an
absolute error of up to ~4·eps·σ² (Q₂₂ ~4·eps·λ²σ²), which at this
configuration's mean spacing (x ≈ 3.5e-3) is 7e-9 of Q₁₁ in float64 but
1.5e-2 of it in float32 — the control's precision — and all of it where a
timestamp repeats (Δt = 0, Q = 0 exactly). So at u < 1 both are taken as
e^{−u} times their Taylor tails, sums of positive terms in which nothing
cancels:

      1 − e^{−u}(1 + u + u²/2) = e^{−u} Σ_{j≥3} u^j/j!,
      1 − e^{−u}(1 − u + u²/2) = e^{−u} (2u + Σ_{j≥3} u^j/j!),

the tail cut after j = 24 (the next term is under 1e-25 of the sum); at
u ≥ 1 as written, where the difference is at least 0.08 and the absolute
error above is under 1e-14 of it in float64.

The filter (Särkkä & García-Fernández 2021, "Temporal parallelization of
Bayesian smoothers", IEEE TAC, §3; arXiv:1905.13002): each step k is an
element (A, b, C, η, J) of an associative operator; the prefix of the
first k elements holds the filtered mean and covariance (b, C) at step
k. For k ≥ 2, with Aₖ, Qₖ the transition into step k and R the noise
variance,

    S = H Qₖ Hᵀ + R,  K = Qₖ Hᵀ / S,
    (A, b, C) = ((I − KH)Aₖ, K yₖ, (I − KH)Qₖ),
    (η, J) = (Aₖᵀ Hᵀ yₖ / S, Aₖᵀ Hᵀ H Aₖ / S);

the first step conditions the stationary prior N(0, P∞) on y₁: A = 0,
b = K y₁, C = P∞ − K S Kᵀ with S = σ² + R, η = 0, J = 0. Two elements
combine (the earlier i, the later j) as

    A = Aⱼ T Aᵢ,   b = Aⱼ T (bᵢ + Cᵢ ηⱼ) + bⱼ,   C = Aⱼ T Cᵢ Aⱼᵀ + Cⱼ,
    η = Aᵢᵀ T′ (ηⱼ − Jⱼ bᵢ) + ηᵢ,   J = Aᵢᵀ T′ Jⱼ Aᵢ + Jᵢ,

T = (I + Cᵢ Jⱼ)⁻¹ and T′ = (I + Jⱼ Cᵢ)⁻¹. The log-likelihood is the sum
over the steps of log N(yₖ; H m⁻ₖ, H P⁻ₖ Hᵀ + R), the predictions
m⁻ₖ = Aₖ mₖ₋₁ and P⁻ₖ = Aₖ Pₖ₋₁ Aₖᵀ + Qₖ from the filtered moments
(m⁻₁ = 0, P⁻₁ = P∞).

Departures from the papers, each exact in exact arithmetic:
- the Taylor tails of Q₁₁ and Q₂₂ at u < 1 (above);
- T′ is taken as Tᵀ: Cᵢ and Jⱼ are symmetric, so (I + Jⱼ Cᵢ) is
  (I + Cᵢ Jⱼ)ᵀ; the 2 × 2 inverse by its adjugate;
- the prefixes come from one work-efficient scan over all N steps at
  once (the paper's up- and down-sweep, here as a recursion: combine the
  pairs, scan their prefixes, and combine each even step's element onto
  the prefix before it), no chunks;
- the prefix's b and C are read as the filtered mean and covariance at
  every step, so the predictions are formed once more from them.

In ``Prec("tf32")``, the control, everything runs in float32 and each
product of two of the 2 × 2 (or 2 × 1) arrays takes the value that
``Prec.mm`` gives, its operands rounded to TF32; its gradient is that of
the float32 product, since the rounding has none.
"""

from __future__ import annotations

import math

import torch

from gpbench.numerics import F64, Prec
from gpbench.reference import _adam as adam
from gpbench.reference.cg_gp import _ieee_f32
from gpbench.reference.exact_gp import raw_start, softplus

_LOG_2PI = math.log(2.0 * math.pi)
_SQRT3 = math.sqrt(3.0)
_TAIL_TERMS = 24   # the Taylor tail Σ_{j=3}^{24} u^j/j!
_TAIL_BELOW = 1.0  # u under which the tails are used


def _mm(a, b, prec: Prec):
    """``a @ b`` over leading batch dimensions, its value as ``prec.mm``
    gives it."""
    exact = a @ b
    if prec.name == "float64":
        return exact
    return exact + (prec.mm(a.detach(), b.detach()) - exact).detach()


def _tail3(u):
    """Σ_{j≥3} u^j/j! = e^u − 1 − u − u²/2, by Horner's rule from j = 24 down
    (u < 1)."""
    acc = torch.zeros_like(u)
    for j in range(_TAIL_TERMS, 2, -1):
        acc = (acc + 1.0) * u / j
    return 0.5 * acc * u * u  # acc = Σ_{j≥3} 2u^{j−2}/j!


def process_noise(dt, s2, lam):
    """(Q₁₁, Q₁₂, Q₂₂) of the Matérn-3/2 SDE over gaps ``dt``."""
    u = 2.0 * lam * dt
    e = torch.exp(-u)
    small = u < _TAIL_BELOW
    us = torch.where(small, u, torch.zeros_like(u))  # the tails' argument, kept < 1
    tail = _tail3(us)
    q11 = torch.where(small, e * tail, 1.0 - e * (1.0 + u + 0.5 * u * u))
    q22 = torch.where(small, e * (2.0 * u + tail), 1.0 - e * (1.0 - u + 0.5 * u * u))
    return s2 * q11, s2 * lam * 0.5 * u * u * e, s2 * lam * lam * q22


def transitions(dt, s2, lam):
    """A = exp(FΔt) and Q, each (n, 2, 2), over gaps ``dt``."""
    x = lam * dt
    e = torch.exp(-x)
    A = e[:, None, None] * torch.stack([torch.stack([1.0 + x, dt], -1),
                                        torch.stack([-lam * x, 1.0 - x], -1)], -2)
    q11, q12, q22 = process_noise(dt, s2, lam)
    Q = torch.stack([torch.stack([q11, q12], -1), torch.stack([q12, q22], -1)], -2)
    return A, Q


def _inv2(M):
    """Inverses of (..., 2, 2) matrices by the adjugate."""
    a, b, c, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return adj / (a * d - b * c)[..., None, None]


def _combiner(prec: Prec):
    def combine(ei, ej):
        """The element of steps i then j; b and η are (…, 2, 1) columns."""
        Ai, bi, Ci, ei_, Ji = ei
        Aj, bj, Cj, ej_, Jj = ej
        eye = torch.eye(2, dtype=Ai.dtype, device=Ai.device)
        T = _inv2(eye + _mm(Ci, Jj, prec))
        AjT = _mm(Aj, T, prec)
        AiTt = _mm(Ai.mT, T.mT, prec)
        return (_mm(AjT, Ai, prec),
                _mm(AjT, bi + _mm(Ci, ej_, prec), prec) + bj,
                _mm(_mm(AjT, Ci, prec), Aj.mT, prec) + Cj,
                _mm(AiTt, ej_ - _mm(Jj, bi, prec), prec) + ei_,
                _mm(_mm(AiTt, Jj, prec), Ai, prec) + Ji)

    return combine


def prefix_scan(elems: tuple, combine) -> tuple:
    """Inclusive prefixes of the elements along axis 0: combine the pairs
    (0, 1), (2, 3), …, scan those, and give each even step after the
    first the prefix before it combined with its own element."""
    n = elems[0].shape[0]
    if n == 1:
        return elems
    h = n // 2
    pairs = combine(tuple(e[0:2 * h:2] for e in elems), tuple(e[1:2 * h:2] for e in elems))
    odd = prefix_scan(pairs, combine)           # prefixes ending at 1, 3, …
    m = (n - 1) // 2
    evens = combine(tuple(o[:m] for o in odd), tuple(e[2::2] for e in elems))  # 2, 4, …
    out = []
    for e, o, ev in zip(elems, odd, evens):
        full = torch.empty_like(e)
        full[0] = e[0]
        full[1::2] = o
        full[2::2] = ev
        out.append(full)
    return tuple(out)


def loglik(t, y, s2, ell, noise, prec: Prec = F64):
    """log N(y; 0, K + noise·I) by the filter; ``t`` sorted."""
    dt_ = prec.dtype
    t, y = prec.cast(t), prec.cast(y)
    s2, ell, noise = (v.to(dt_) for v in (s2, ell, noise))
    n = t.shape[0]
    lam = _SQRT3 / ell
    eye = torch.eye(2, dtype=dt_, device=t.device)
    H = torch.tensor([[1.0, 0.0]], dtype=dt_, device=t.device)        # (1, 2)
    Pinf = torch.diag(torch.stack([s2, lam * lam * s2]))
    A, Q = transitions(torch.diff(t), s2, lam)                        # steps 2..n
    yc = y[:, None, None]                                             # (n, 1, 1)

    # the first step: the stationary prior conditioned on y₁
    S1 = s2 + noise
    K1 = Pinf[:, :1] / S1                                             # (2, 1)
    first = (torch.zeros((1, 2, 2), dtype=dt_, device=t.device), (K1 * yc[0])[None],
             (Pinf - _mm(K1, K1.T, prec) * S1)[None],
             torch.zeros((1, 2, 1), dtype=dt_, device=t.device),
             torch.zeros((1, 2, 2), dtype=dt_, device=t.device))
    # the others
    S = Q[:, 0, 0] + noise                                            # (n-1,)
    K = Q[:, :, :1] / S[:, None, None]                                # (n-1, 2, 1)
    IKH = eye - _mm(K, H.expand(n - 1, 1, 2), prec)
    HA = A[:, :1, :]                                                  # H Aₖ, (n-1, 1, 2)
    rest = (_mm(IKH, A, prec), K * yc[1:], _mm(IKH, Q, prec),
            HA.mT * (yc[1:] / S[:, None, None]),
            _mm(HA.mT, HA, prec) / S[:, None, None])
    elems = tuple(torch.cat([f, r]) for f, r in zip(first, rest))
    _, m, P, _, _ = prefix_scan(elems, _combiner(prec))

    # predictions and the likelihood's terms
    m_pred = torch.cat([torch.zeros((1, 2, 1), dtype=dt_, device=t.device),
                        _mm(A, m[:-1], prec)])
    P_pred = torch.cat([Pinf[None], _mm(_mm(A, P[:-1], prec), A.mT, prec) + Q])
    v = y - m_pred[:, 0, 0]
    Sp = P_pred[:, 0, 0] + noise
    return -0.5 * (n * _LOG_2PI + torch.log(Sp).sum() + (v * v / Sp).sum())


def nlml(raw: dict, t, y, prec: Prec = F64):
    """−log p(y) at the raw leaves {ell, noise, s2} (softplus of each)."""
    s2, ell, noise = (softplus(raw[k]) for k in ("s2", "ell", "noise"))
    return -loglik(t, y, s2, ell, noise, prec)


def train_steps(cfg: dict, traffic: dict, inputs: dict, prec: Prec = F64) -> dict:
    """Follow the program's first ``steps`` Adam steps from the same start
    on the same data (``inputs``: t, y, steps, and start or raw)."""
    raw0 = raw_start(inputs, ("s2", "ell", "noise"), prec)
    with _ieee_f32():
        return adam.follow(lambda r: nlml(r, inputs["t"], inputs["y"], prec), raw0,
                           inputs["steps"], traffic["learning_rate"])
