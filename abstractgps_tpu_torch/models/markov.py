"""Markov (state-space) GP backend: linear-time exact inference in 1-D.

Counterpart of the JAX package's ``models/markov.py``. Matérn kernels in
1-D are exactly the covariance functions of linear time-invariant SDEs
(Hartikainen & Särkkä 2010), so for sorted inputs the GP is a Gauss–Markov
chain and

- ``markov_logpdf``       ≡ ``fx.logpdf(y)``                    in O(N·p³)
- ``markov_mean_and_var`` ≡ exact-posterior ``mean_and_var``    in O(N·p³)

with state dimension p ∈ {1, 2, 3} a component. Two execution strategies:

- the sequential Kalman filter and RTS smoother, a Python loop over the
  steps (O(N) depth, a few launches a step on the card);
- the **parallel-in-time** filter (Särkkä & García-Fernández 2020) as an
  associative scan, ``parallel=True``: the odd/even recursion of
  ``lax.associative_scan`` within chunks of ``_PAR_CHUNK`` steps, batched
  over the chunks, then the cross-chunk prefixes by a second such
  recursion over the chunks' totals. No loop over steps or chunks, so it
  is the one to run at N = 10⁶.

Supported kernels: ExponentialKernel/Matern12 (p=1), Matern32 (p=2),
Matern52 (p=3), scaled (``σ² * k``) and lengthscale
(``with_lengthscale`` / ``ScaleTransform``) versions, and sums of these
(block-diagonal state augmentation). Anything else raises ``TypeError``.

Discretization uses the exact matrix exponential: the Matérn companion
matrix ``F`` has a single eigenvalue ``−λ``, so ``N = F + λI`` is nilpotent
of degree p and ``expm(F·dt) = e^{−λ·dt} (I + N·dt + (N·dt)²/2)`` exactly.
Process noise is computed in cancellation-free incomplete-gamma closed form
(``_stable_Q``) rather than as ``P∞ − A P∞ Aᵀ``.

Deliberate divergence from the JAX package: ``_stable_Q`` writes P(1, x)
as ``−expm1(−x)``, the same function with a finite derivative at x = 0,
where ``gammainc(1, ·)``'s derivative is NaN. Repeated timepoints (dt = 0)
therefore give finite lengthscale gradients here; the JAX package's are NaN.
And the chunked scan's cross-chunk carries are an odd/even scan over the
chunk totals (``_chunked_associative_scan``), where the JAX package folds
them left to right: the same products, rounded in another association.

f32 accuracy contract (f64 is exact to ~1e-9): single Matérn components
hold ~1e-4 relative logpdf error at densely sampled inputs; kernel SUMS
degrade with component redundancy (up to ~1.8e-2 for two identical
components), as in the JAX package. Every matmul and solve runs at IEEE f32
(``full_f32``), never TF32. Gradients flow through plain torch ops.
"""

from __future__ import annotations

import math

import torch

from ..kernels.base import Kernel, KernelSum, ScaledKernel, ScaleTransform, TransformedKernel
from ..kernels.stationary import ExponentialKernel, Matern32Kernel, Matern52Kernel
from ..means import mean_vector
from ..ops.distance import as_inputs, as_tensor
from ..ops.draws import as_draws
from ..ops.noise import DenseNoise, as_noise
from ..ops.precision import full_f32
from ..utils.profiling import LIBRARY_CALLS, span
from .gp import AbstractGP

__all__ = [
    "sde_coefficients",
    "markov_logpdf",
    "markov_mean_and_var",
    "markov_rand",
    "markov_posterior",
    "MarkovPosteriorGP",
    "is_markov_kernel",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _mv(M, v):
    """Batched matrix-vector product ``M @ v`` over broadcast leading dims."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


# ---------------------------------------------------------------------------
# Kernel → SDE coefficients
# ---------------------------------------------------------------------------


def _base_order(kernel) -> int | None:
    if isinstance(kernel, ExponentialKernel):
        return 1
    if isinstance(kernel, Matern32Kernel):
        return 2
    if isinstance(kernel, Matern52Kernel):
        return 3
    return None


def _scalar(v, dtype, device) -> torch.Tensor:
    """A 0-dim tensor of ``dtype``: a tensor keeps its autograd graph (and
    its device unless ``device`` is given); a number is made on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=dtype, device=device if device is not None else v.device)
    return torch.tensor(v, dtype=dtype, device=device)


def sde_coefficients(kernel: Kernel, dtype=torch.float64, device=None):
    """Flatten a Markov-representable kernel into per-component (λ, p, σ²).

    Components come from summands; scaling multiplies σ²; a ScaleTransform s
    (lengthscale ℓ = 1/s) multiplies λ. Returns a list of
    ``(lam, order, variance)`` with lam and variance 0-dim tensors of
    ``dtype`` that stay in the autograd graph of the kernel's tensors.
    Raises TypeError for kernels with no exact state-space form.
    """
    out = []

    def visit(k, var_scale, len_scale):
        if isinstance(k, KernelSum):
            for kk in k.kernels:
                visit(kk, var_scale, len_scale)
            return
        if isinstance(k, ScaledKernel):
            visit(k.kernel, var_scale * k.variance, len_scale)
            return
        if isinstance(k, TransformedKernel):
            if not isinstance(k.transform, ScaleTransform):
                raise TypeError(
                    "markov backend supports only ScaleTransform (lengthscale) "
                    f"input transforms, got {type(k.transform).__name__}"
                )
            visit(k.kernel, var_scale, len_scale * k.transform.s)
            return
        p = _base_order(k)
        if p is None:
            raise TypeError(
                f"kernel {type(k).__name__} has no exact 1-D state-space form; "
                "supported: Exponential/Matern12, Matern32, Matern52, their "
                "scaled/lengthscale versions, and sums thereof"
            )
        root = {1: 1.0, 2: math.sqrt(3.0), 3: math.sqrt(5.0)}[p]
        ls = _scalar(len_scale, dtype, device)
        lam = torch.tensor(root, dtype=dtype, device=ls.device) * ls
        out.append((lam, p, _scalar(var_scale, dtype, device)))

    visit(kernel, 1.0, 1.0)
    return out


def is_markov_kernel(kernel: Kernel) -> bool:
    """True if ``sde_coefficients`` accepts this kernel."""
    try:
        sde_coefficients(kernel)
        return True
    except TypeError:
        return False


def _component_matrices(lam, p: int, var, dtype):
    """(F+λI nilpotent N, P∞, H-row) for one Matérn component."""
    dev = lam.device
    z = torch.zeros_like(lam)
    one = torch.ones_like(lam)
    if p == 1:
        N = torch.zeros((1, 1), dtype=dtype, device=dev)
        P = var * torch.ones((1, 1), dtype=dtype, device=dev)
    elif p == 2:
        N = torch.stack([torch.stack([lam, one]), torch.stack([-(lam**2), -lam])])
        P = var * torch.diag(torch.stack([one, lam**2]))
    elif p == 3:
        N = torch.stack([
            torch.stack([lam, one, z]),
            torch.stack([z, lam, one]),
            torch.stack([-(lam**3), -3.0 * lam**2, -2.0 * lam]),
        ])
        k2 = lam**2 / 3.0
        P = var * torch.stack([
            torch.stack([one, z, -k2]),
            torch.stack([z, k2, z]),
            torch.stack([-k2, z, lam**4]),
        ])
    else:  # pragma: no cover
        raise ValueError(p)
    H = torch.zeros((p,), dtype=dtype, device=dev)
    H[0] = 1.0
    return N, P, H


def _stable_Q(lam, p: int, var, dts, dtype):
    """Process noise Q(dt) in cancellation-free closed form, (n, p, p).

    ``Q = P∞ − A P∞ Aᵀ`` is exact algebra but catastrophic numerics at
    small λ·dt: Q₁₁ ~ (λdt)^(2p−1) computed as a difference of O(1) terms.
    Instead integrate the white-noise forcing directly: with
    v(s) = e^{λs}·(e^{Fs}L) a degree-(p−1) polynomial (F+λI is nilpotent),
    every entry is

        Q_ij = q ∫₀^dt v_i v_j e^{−2λs} ds = q Σ_k c_k · I_k,
        I_k  = k!/(2λ)^{k+1} · P(k+1, 2λdt),

    with P the regularized lower incomplete gamma
    (``torch.special.gammainc``, differentiated in x; the a's are the
    constants 1-5). P(1, x) = 1 − e⁻ˣ is written ``−expm1(−x)``: the same
    values, and a derivative that is finite at x = 0 (repeated timepoints),
    where ``gammainc(1, ·)``'s is NaN. Q₁₁ = σ²P(2p−1, 2λdt).
    """
    x = (2.0 * lam * dts).to(dtype)

    def P(a):
        if a == 1:
            return -torch.expm1(-x)
        return torch.special.gammainc(torch.full_like(x, float(a)), x)

    if p == 1:
        q11 = var * P(1)
        return q11[:, None, None]
    if p == 2:
        P2, P3 = P(2), P(3)
        q11 = var * P3
        q12 = var * lam * (P2 - P3)
        q22 = var * lam**2 * (2.0 * P(1) - 2.0 * P2 + P3)
        row1 = torch.stack([q11, q12], dim=-1)
        row2 = torch.stack([q12, q22], dim=-1)
        return torch.stack([row1, row2], dim=-2)
    if p == 3:
        P1, P2, P3, P4, P5 = (P(a) for a in range(1, 6))
        l2 = lam * lam
        q11 = var * P5
        q12 = var * lam * (P4 - P5)
        q13 = var * l2 / 3.0 * (2.0 * P3 - 6.0 * P4 + 3.0 * P5)
        q22 = var * l2 / 3.0 * (4.0 * P3 - 6.0 * P4 + 3.0 * P5)
        q23 = var * lam * l2 / 3.0 * (4.0 * P2 - 10.0 * P3 + 9.0 * P4 - 3.0 * P5)
        q33 = var * l2 * l2 / 3.0 * (
            8.0 * P1 - 16.0 * P2 + 20.0 * P3 - 12.0 * P4 + 3.0 * P5)
        row1 = torch.stack([q11, q12, q13], dim=-1)
        row2 = torch.stack([q12, q22, q23], dim=-1)
        row3 = torch.stack([q13, q23, q33], dim=-1)
        return torch.stack([row1, row2, row3], dim=-2)
    raise ValueError(p)  # pragma: no cover


def _blkdiag(mats, D, lead=()):
    """Block-diagonal (*lead, D, D) assembly of (*lead, p, p) blocks."""
    out = mats[0].new_zeros(lead + (D, D))
    o = 0
    for m in mats:
        pp = m.shape[-1]
        out[..., o:o + pp, o:o + pp] = m
        o += pp
    return out


def _build_ssm(kernel, x_sorted, dtype):
    """Batched discrete-time model over the sorted timeline.

    Returns (A, Q, H, Pinf) with A/Q shaped (n, D, D); step 0 encodes the
    stationary prior via A=0, Q=P∞ so the filter needs no special casing.
    """
    with span("ops.markov.ssm"):
        comps = sde_coefficients(kernel, dtype, x_sorted.device)
        dts = torch.diff(x_sorted)  # (n-1,)

        blocks_A, blocks_Q, Hs, Ps = [], [], [], []
        for lam, p, var in comps:
            N, P, H = _component_matrices(lam, p, var, dtype)
            eye = torch.eye(p, dtype=dtype, device=x_sorted.device)
            # A_of broadcast over the n-1 steps
            Ndt = N * dts[:, None, None]
            series = eye + Ndt
            if p == 3:
                series = series + 0.5 * (Ndt @ Ndt)
            blocks_A.append(torch.exp(-lam * dts)[:, None, None] * series)  # (n-1, p, p)
            blocks_Q.append(_stable_Q(lam, p, var, dts, dtype))
            Hs.append(H)
            Ps.append(P)

        D = sum(b.shape[-1] for b in blocks_A)
        A_steps = _blkdiag(blocks_A, D, (dts.shape[0],))  # (n-1, D, D)
        Q_steps = _blkdiag(blocks_Q, D, (dts.shape[0],))
        Pinf = _blkdiag(Ps, D)
        H = torch.cat(Hs)  # (D,)

        A = torch.cat([A_steps.new_zeros((1, D, D)), A_steps], dim=0)
        Q = torch.cat([Pinf[None], Q_steps], dim=0)
        return A, Q, H, Pinf


# ---------------------------------------------------------------------------
# Filtering
# ---------------------------------------------------------------------------


def _seq_filter(A, Q, H, y, r, obs_mask):
    """Sequential Kalman filter, a loop over the n steps. ``y`` is (n,) or
    (n, *batch): the batch (the columns of a matrix y) rides along in the
    carried mean; the covariance does not depend on y and is shared.
    Returns per-step filtered (m, P), one-step predictions (m_pred,
    P_pred), and the total loglik of observed steps (shape ``batch``).
    ``r`` is the per-step observation noise variance."""
    D = H.shape[0]
    eye = torch.eye(D, dtype=H.dtype, device=H.device)
    m = H.new_zeros(tuple(y.shape[1:]) + (D,))
    P = H.new_zeros((D, D))
    m_f, P_f, m_p, P_p, lls = [], [], [], [], []
    for k in range(A.shape[0]):
        Ak, Qk, yk, rk, ok = A[k], Q[k], y[k], r[k], obs_mask[k]
        m_pred = _mv(Ak, m)
        P_pred = Ak @ P @ Ak.T + Qk
        v = yk - m_pred @ H
        S = H @ P_pred @ H + rk
        K = (P_pred @ H) / S
        ll = -0.5 * (_LOG_2PI + torch.log(S) + v * v / S)
        Km = torch.where(ok, K, torch.zeros_like(K))
        m = m_pred + Km * v[..., None]
        IKH = eye - torch.outer(Km, H)
        P = IKH @ P_pred @ IKH.T + rk * torch.outer(Km, Km)  # Joseph form
        lls.append(torch.where(ok, ll, torch.zeros_like(ll)))
        m_f.append(m)
        P_f.append(P)
        m_p.append(m_pred)
        P_p.append(P_pred)
    stack = torch.stack
    return stack(m_f), stack(P_f), stack(m_p), stack(P_p), stack(lls).sum(0)


def _inv_posdef_small(M):
    """Batched inverse of (..., D, D) matrices, closed-form for D ≤ 3.

    The parallel-filter combine inverts ``I + C J`` at every scan level;
    adjugate/determinant closed forms are branch-free elementwise math for
    the p ∈ {1,2,3} Matérn state dims. D > 3 (big kernel sums) goes to
    ``torch.linalg.solve_ex`` (``solve`` without its error check, which
    would read the device's info flag back to the host).
    """
    D = M.shape[-1]
    if D == 1:
        return 1.0 / M
    if D == 2:
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, d = M[..., 1, 0], M[..., 1, 1]
        det = a * d - b * c
        return torch.stack([
            torch.stack([d, -b], dim=-1),
            torch.stack([-c, a], dim=-1),
        ], dim=-2) / det[..., None, None]
    if D == 3:
        a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
        g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
        A_ = e * i - f * h
        B_ = -(d * i - f * g)
        C_ = d * h - e * g
        det = a * A_ + b * B_ + c * C_
        adjT = torch.stack([
            torch.stack([A_, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B_, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C_, -(a * h - b * g), a * e - b * d], dim=-1),
        ], dim=-2)
        return adjT / det[..., None, None]
    eye = torch.eye(D, dtype=M.dtype, device=M.device)
    return torch.linalg.solve_ex(M, eye.expand(M.shape))[0]


def _interleave(a, b, axis):
    """a[0], b[0], a[1], b[1], ... along ``axis`` (a one longer or equal)."""
    if a.shape[axis] == b.shape[axis]:
        return torch.stack([a, b], dim=axis + 1).flatten(axis, axis + 1)
    head = a.narrow(axis, 0, b.shape[axis])
    pairs = torch.stack([head, b], dim=axis + 1).flatten(axis, axis + 1)
    return torch.cat([pairs, a.narrow(axis, a.shape[axis] - 1, 1)], dim=axis)


def _associative_scan(combine, elems, axis=0):
    """Inclusive scan of a tuple of tensors along ``axis`` with an
    associative ``combine`` (which must broadcast over leading dims): the
    odd/even recursion of ``lax.associative_scan``, so the port combines the
    same pairs in the same order. Pairs are combined, the half-length
    sequence is scanned recursively (the odd outputs), and each even output
    combines the preceding odd output with its own element; the first
    element passes through."""

    def sl(x, start, stop=None, step=1):
        return x[(slice(None),) * axis + (slice(start, stop, step),)]

    def scan(elems):
        num = elems[0].shape[axis]
        if num < 2:
            return elems
        reduced = combine(tuple(sl(e, 0, -1, 2) for e in elems),
                          tuple(sl(e, 1, None, 2) for e in elems))
        odd = scan(reduced)
        rest = tuple(sl(e, 2, None, 2) for e in elems)
        if num % 2 == 0:
            even = combine(tuple(sl(e, 0, -1) for e in odd), rest)
        else:
            even = combine(odd, rest)
        even = tuple(torch.cat([sl(e, 0, 1), r], dim=axis) for e, r in zip(elems, even))
        return tuple(_interleave(a, b, axis) for a, b in zip(even, odd))

    return scan(tuple(elems))


_PAR_CHUNK = 4096  # inner associative-scan width for the chunked filter


def _chunked_associative_scan(combine, elems, identity, chunk=None):
    """Inclusive associative scan over axis 0 in chunks of ``chunk``.

    The JAX package's blocked decomposition: pad to whole chunks, scan
    within each chunk, then compose the running cross-chunk prefix into
    every element. (1) One odd/even recursion over all chunks at once, on a
    (chunks, chunk, …) batch. (2) The cross-chunk carries: chunk c's carry
    is the inclusive prefix of chunks 0 … c−1's totals (each chunk's last
    within-chunk output), so the carries are one more ``_associative_scan``
    of the same monoid, over the first ``chunks − 1`` totals, in log₂ depth
    with two batched combines a level; the first chunk's carry is the
    identity. (3) One batched ``combine(carry, within)``.

    Rounding: the JAX package folds the carries left to right in its
    ``lax.scan``, a fold that eager torch would issue combine by combine
    from the host. Here each carry is the same product of the same totals,
    associated as the odd/even tree associates them, as within a chunk and
    in the unchunked scan.

    ``identity`` is the monoid's left identity (combine(identity, x) == x),
    the first chunk's carry. The tail is padded with all-zero elements and
    the padded outputs sliced off — ``combine`` must be well-defined (no
    NaN/inf) on zero elements. Only the last chunk holds padding, and its
    total enters no carry.

    Spans: ``ops.markov.scan`` around (1) and around (3),
    ``ops.markov.carry`` around (2); ``LIBRARY_CALLS["markov_carry_combine"]``
    counts (2)'s combines, two a level of its recursion.
    """
    if chunk is None:
        chunk = _PAR_CHUNK  # late-bound so tests/tuning can override
    n = elems[0].shape[0]
    if n <= chunk:
        with span("ops.markov.scan"):
            return _associative_scan(combine, elems)
    pad = (-n) % chunk
    nc = (n + pad) // chunk

    def pad_reshape(x):
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return x.reshape((nc, chunk) + tuple(x.shape[1:]))

    def counted(e1, e2):
        LIBRARY_CALLS["markov_carry_combine"] += 1
        return combine(e1, e2)

    with span("ops.markov.scan"):
        within = _associative_scan(combine, tuple(pad_reshape(x) for x in elems), axis=1)
    with span("ops.markov.carry"):
        prefixes = _associative_scan(counted, tuple(w[:-1, -1] for w in within))
        carries = tuple(torch.cat([torch.broadcast_to(i, w.shape[2:])[None], p])
                        for i, w, p in zip(identity, within, prefixes))
    with span("ops.markov.scan"):
        out = combine(tuple(c[:, None] for c in carries), within)
        return tuple(o.reshape((-1,) + tuple(o.shape[2:]))[:n] for o in out)


def _element_combine(eye):
    """The associative operator of the filtering elements (A, b, C, η, J)
    (Särkkä & García-Fernández 2020), batched over leading dims;
    ``eye`` is the (D, D) identity of the state."""

    def combine(e1, e2):
        A1, b1, C1, e1t, J1 = e1
        A2, b2, C2, e2t, J2 = e2
        T = _inv_posdef_small(eye + C1 @ J2)
        AT = A2 @ T
        Anew = AT @ A1
        bnew = _mv(AT, b1 + _mv(C1, e2t)) + b2
        Cnew = AT @ C1 @ A2.mT + C2
        Tt = _inv_posdef_small(eye + J2 @ C1)
        A1T = A1.mT @ Tt
        enew = _mv(A1T, e2t - _mv(J2, b1)) + e1t
        Jnew = A1T @ J2 @ A1 + J1
        return (Anew, bnew, Cnew, enew, Jnew)

    return combine


def _par_filter(A, Q, H, y, r, obs_mask):
    """Parallel-in-time Kalman filter via associative scan
    (Särkkä & García-Fernández 2020, filtering elements). O(log N) depth,
    within chunks and across them (``_chunked_associative_scan``). Same outputs as
    ``_seq_filter``; ``y`` may carry a batch after its time axis.

    Unobserved steps degenerate to pure prediction elements (K = 0, η = 0,
    J = 0). Step 0's A=0/Q=P∞ encodes the stationary prior exactly as in
    the sequential filter. The marginal likelihood is reassembled afterwards
    from the filtered means/covs shifted by one step (vectorized).

    Padding note: the chunked scan pads the tail with all-zeros elements.
    A zero element (A=0, b=0, C=0, η=0, J=0) is ABSORBING on the
    left-argument side, not an identity, but padded outputs are sliced off
    before use and zero J/C keep every inverse well-posed (T = (I + 0)⁻¹),
    so the first n outputs are exact.
    """
    n, D = A.shape[0], H.shape[0]
    eye = torch.eye(D, dtype=H.dtype, device=H.device)
    batch = tuple(y.shape[1:])
    ones = (1,) * len(batch)

    with span("ops.markov.ssm"):  # the filtering elements
        S = torch.einsum("i,nij,j->n", H, Q, H) + r                      # (n,)
        K = torch.where(obs_mask[:, None], (Q @ H) / S[:, None], 0.0)    # (n, D)
        IKH = eye - K[:, :, None] * H[None, None, :]                     # (n, D, D)
        A_el = IKH @ A
        C_el = IKH @ Q
        HS = torch.where(obs_mask[:, None], H[None, :] / S[:, None], 0.0)  # (n, D)
        AtHS = torch.einsum("nji,nj->ni", A, HS)                         # Aᵀ H / S
        J_el = AtHS[:, :, None] * torch.einsum("nij,i->nj", A, H)[:, None, :]
        yb = y.reshape((n,) + batch + (1,))
        b_el = K.reshape((n,) + ones + (D,)) * yb
        eta_el = AtHS.reshape((n,) + ones + (D,)) * yb

    def mat(M):
        return M.reshape((n,) + ones + (D, D))

    # identity of the filtering-element monoid: combine(id, x) == x
    zv, zm = H.new_zeros((D,)), H.new_zeros((D, D))
    identity = (eye, zv, zm, zv, zm)
    _, b_f, C_f, _, _ = _chunked_associative_scan(
        _element_combine(eye), (mat(A_el), b_el, mat(C_el), eta_el, mat(J_el)), identity
    )
    m_f, P_f = b_f, C_f.reshape(n, D, D)  # filtered moments

    with span("ops.markov.likelihood"):
        # predictions: m_pred_k = A_k m_{k-1}, P_pred_k = A_k P_{k-1} A_kᵀ + Q_k
        m_prev = torch.cat([m_f.new_zeros((1,) + tuple(m_f.shape[1:])), m_f[:-1]], dim=0)
        P_prev = torch.cat([P_f.new_zeros((1, D, D)), P_f[:-1]], dim=0)
        m_p = _mv(mat(A), m_prev)
        P_p = A @ P_prev @ A.mT + Q

        v = y - m_p @ H
        Sp = (torch.einsum("i,nij,j->n", H, P_p, H) + r).reshape((n,) + ones)
        terms = -0.5 * (_LOG_2PI + torch.log(Sp) + v * v / Sp)
        lls = torch.where(obs_mask.reshape((n,) + ones), terms, 0.0)
        return m_f, P_f, m_p, P_p, lls.sum(0)


def _rts_smoother(A, m_f, P_f, m_p, P_p):
    """Sequential RTS smoother (a reverse loop) over the filtered pass."""
    ms, Ps, _ = _rts_smoother_gains(A, m_f, P_f, m_p, P_p)
    return ms, Ps


def _rts_smoother_gains(A, m_f, P_f, m_p, P_p):
    """RTS smoother that also returns the gains ``G_k`` (k = 0..n−2).

    ``G_k = P_k^f A_{k+1}ᵀ (P_{k+1}^p)⁻¹`` links state k to k+1; the gains
    turn the smoother into a JOINT posterior over the whole timeline:
    ``Cov(s_i, s_j) = G_i G_{i+1} … G_{j−1} P_j^s`` for i < j (the smoothed
    chain is itself Gauss–Markov — Särkkä, *Bayesian Filtering and
    Smoothing*, Thm 8.2).
    """
    n = m_f.shape[0]
    ms_next, Ps_next = m_f[-1], P_f[-1]
    ms, Ps, Gs = [ms_next], [Ps_next], []
    for k in range(n - 2, -1, -1):
        Pk, Pp_next = P_f[k], P_p[k + 1]
        G = torch.linalg.solve_ex(Pp_next.T, (Pk @ A[k + 1].T).T)[0].T
        ms_next = m_f[k] + G @ (ms_next - m_p[k + 1])
        Ps_next = Pk + G @ (Ps_next - Pp_next) @ G.T
        ms.append(ms_next)
        Ps.append(Ps_next)
        Gs.append(G)
    D = m_f.shape[-1]
    Gs = torch.stack(Gs[::-1]) if Gs else m_f.new_zeros((0, D, D))
    return torch.stack(ms[::-1]), torch.stack(Ps[::-1]), Gs


def _pairwise_fcov(H, Gs, Ps):
    """Full pairwise posterior covariance of ``f = Hᵀs`` over the timeline.

    ``F[i, j] = Hᵀ (G_i … G_{j−1} P_j^s) H`` (i ≤ j), symmetrised. One
    loop over the columns with a carried (n, D, D) product table —
    O(n²·p³) work for an inherently O(n²) output. ``_posterior_joint``
    pre-collapses the training timeline into between-QUERY segment
    products, so n here is the number of query points, never the training
    size.
    """
    n, D = Ps.shape[0], Ps.shape[1]
    eye = torch.eye(D, dtype=Ps.dtype, device=Ps.device)
    idx = torch.arange(n, device=Ps.device)
    U = eye.expand(n, D, D)
    Gpad = torch.cat([Gs, eye[None]], dim=0)
    cols = []
    for j in range(n):
        col = torch.einsum("a,nab,bc,c->n", H, U, Ps[j], H)
        cols.append(torch.where(idx <= j, col, 0.0))
        U = torch.where((idx == j + 1)[:, None, None], eye, U @ Gpad[j])
    F_ut = torch.stack(cols).T  # (i, j) upper triangle (i ≤ j)
    return F_ut + F_ut.T - torch.diag(torch.diagonal(F_ut))


# ---------------------------------------------------------------------------
# Public API (drop-ins for the dense operations)
# ---------------------------------------------------------------------------


def _prep(fx, y):
    x = as_inputs(fx.x)
    if x.shape[1] != 1:
        raise TypeError("markov backend requires 1-D inputs")
    if isinstance(fx.noise, DenseNoise):
        raise TypeError("markov backend requires diagonal-structured noise")
    t = x[:, 0]
    dtype = t.dtype
    order = torch.argsort(t, stable=True)
    r = as_noise(fx.noise, t.shape[0]).diag().to(dtype)
    y = as_tensor(y, dtype=dtype, device=t.device)
    return t[order], y[order], r[order], order, dtype


@full_f32()
def markov_logpdf(fx, y, parallel: bool = False) -> torch.Tensor:
    """``fx.logpdf(y)`` in O(N) time / memory for Markov kernels on 1-D x.

    Exact (held against the dense Cholesky path to 1e-8 in f64); inputs
    need not be sorted. ``y`` may be a vector (n,) → scalar, or a matrix
    (n, q) → (q,) of column-wise log densities (the FiniteGP contract; the
    columns share one pass of the filter). ``parallel=True`` uses the
    associative-scan filter (O(log N) depth, no per-step loop). A
    ``model.markov_logpdf`` span.
    """
    with span("model.markov_logpdf"):
        ts, ys, rs, _, dtype = _prep(fx, y)
        m = mean_vector(fx.f.mean_fn, ts[:, None]).to(dtype)
        A, Q, H, _ = _build_ssm(fx.f.kernel, ts, dtype)
        obs = torch.ones(ts.shape, dtype=torch.bool, device=ts.device)
        run = _par_filter if parallel else _seq_filter
        yc = ys - (m if ys.ndim == 1 else m[:, None])
        return run(A, Q, H, yc, rs, obs)[-1]


def _merged_timeline(fx, y, x_test):
    """Sorted union of train/test timepoints with observation mask; returns
    everything needed to filter, plus the slice info to recover test points."""
    xt = as_inputs(x_test)
    if xt.shape[1] != 1:
        raise TypeError("markov backend requires 1-D inputs")
    ts, ys, rs, _, dtype = _prep(fx, y)
    tt = xt[:, 0].to(dtype=dtype, device=ts.device)

    t_all = torch.cat([ts, tt])
    y_all = torch.cat([ys, torch.zeros_like(tt)])
    r_all = torch.cat([rs, torch.ones_like(tt)])  # dummy; masked out
    obs_all = torch.cat([torch.ones(ts.shape, dtype=torch.bool, device=ts.device),
                         torch.zeros(tt.shape, dtype=torch.bool, device=ts.device)])
    order = torch.argsort(t_all, stable=True)
    t_s, y_s, r_s, o_s = t_all[order], y_all[order], r_all[order], obs_all[order]
    prior_mean_s = mean_vector(fx.f.mean_fn, t_s[:, None]).to(dtype)
    return t_s, y_s - prior_mean_s, r_s, o_s, prior_mean_s, order, ts.shape[0], dtype


def _filtered(fx, y, x_test, parallel):
    """The merged timeline, its model and one filtering pass over it."""
    t_s, y_s, r_s, o_s, prior_mean_s, order, n_train, dtype = _merged_timeline(
        fx, y, x_test
    )
    A, Q, H, _ = _build_ssm(fx.f.kernel, t_s, dtype)
    run = _par_filter if parallel else _seq_filter
    m_f, P_f, m_p, P_p, _ = run(A, Q, H, y_s, r_s, o_s)
    return (A, H, m_f, P_f, m_p, P_p), prior_mean_s, order, n_train


@full_f32()
def markov_rand(fx, y, x_test, generator=None, num_samples: int | None = None,
                parallel: bool = False):
    """Joint posterior samples of the latent f at ``x_test`` in O(N+M) —
    the Markov drop-in for ``posterior(fx, y)(x_test, 0).rand(generator[, S])``.

    Forward-filter backward-sample (FFBS): one shared filtering pass over
    the merged timeline, then a reverse loop drawing
    ``x_k | x_{k+1} ~ N(m_k + G_k(x_{k+1} − m̂_{k+1}), P_k − G_k P̂_{k+1} G_kᵀ)``
    for all samples at once. ``generator`` is a ``torch.Generator``, an int
    seed or a draws object (``ops.draws``); ε is one ``normal((n_all, S,
    D))`` draw, as the JAX package's.
    """
    (A, H, m_f, P_f, m_p, P_p), prior_mean_s, order, n_train = _filtered(
        fx, y, x_test, parallel)
    dtype, dev = m_f.dtype, m_f.device
    S = 1 if num_samples is None else num_samples
    D = H.shape[0]
    n_all = m_f.shape[0]
    eps = as_draws(generator, dev).normal((n_all, S, D), dtype, dev)
    eye = torch.eye(D, dtype=dtype, device=dev)

    def safe_chol(M):
        # P can be exactly singular (e.g. duplicated timepoints); jitter
        # proportional to the trace AND the dtype's resolution keeps the
        # draw well-defined in f32 too (a fixed 1e-12 is below f32 eps).
        jit = 100.0 * torch.finfo(dtype).eps * (torch.trace(M) + 1.0)
        return torch.linalg.cholesky_ex(M + jit * eye)[0]

    x_next = m_f[-1][None, :] + eps[-1] @ safe_chol(P_f[-1]).T  # (S, D)
    xs = [x_next]
    for k in range(n_all - 2, -1, -1):
        Pk, Pp_next = P_f[k], P_p[k + 1]
        G = torch.linalg.solve_ex(Pp_next.T, (Pk @ A[k + 1].T).T)[0].T
        cond_mean = m_f[k][None, :] + (x_next - m_p[k + 1][None, :]) @ G.T
        cond_cov = Pk - G @ Pp_next @ G.T
        Lc = safe_chol(0.5 * (cond_cov + cond_cov.T))
        x_next = cond_mean + eps[k] @ Lc.T
        xs.append(x_next)
    xs = torch.stack(xs[::-1])  # (n_all, S, D)

    f_s = xs @ H + prior_mean_s[:, None]  # (n_all, S)
    inv = torch.argsort(order)
    f_test = f_s[inv][n_train:]  # (M, S)
    return f_test[:, 0] if num_samples is None else f_test


@full_f32()
def markov_mean_and_var(fx, y, x_test, parallel: bool = False):
    """Posterior-predictive marginals ``posterior(fx, y)(x_test)`` —
    latent mean and variance at ``x_test`` — in O((N+M)·p³).

    Runs filter + RTS smoother over the merged train/test timeline with
    test points carried as unobserved steps.
    """
    (A, H, m_f, P_f, m_p, P_p), prior_mean_s, order, n_train = _filtered(
        fx, y, x_test, parallel)
    ms, Ps = _rts_smoother(A, m_f, P_f, m_p, P_p)

    mean_s = ms @ H + prior_mean_s
    var_s = torch.clamp(torch.einsum("i,nij,j->n", H, Ps, H), min=0.0)

    # scatter back to the merged order, then slice out the test entries
    inv = torch.argsort(order)
    return mean_s[inv][n_train:], var_s[inv][n_train:]


@full_f32()
def _posterior_joint(fx, y, x_test, parallel: bool = False):
    """Posterior mean AND full covariance of f at ``x_test`` — one
    filter+smoother pass plus pairwise gain products over the QUERY
    points only.

    The pairwise table is O(M²) in the M query points, never in the
    training size: one O(n·p³) loop over the merged timeline collapses
    each between-query gain chain into a single segment product
    ``S_a = G_{q_a} … G_{q_{a+1}−1}`` (resetting the running product at
    every query position), and ``_pairwise_fcov`` then runs over the M
    segment products.
    """
    (A, H, m_f, P_f, m_p, P_p), prior_mean_s, order, n_train = _filtered(
        fx, y, x_test, parallel)
    ms, Ps, Gs = _rts_smoother_gains(A, m_f, P_f, m_p, P_p)
    mean_s = ms @ H + prior_mean_s

    sel = torch.argsort(order)[n_train:]   # merged positions, USER order
    if sel.shape[0] == 0:  # empty query set: (0,) mean, (0, 0) covariance
        return mean_s[sel], mean_s.new_zeros((0, 0))
    ord_q = torch.argsort(sel)             # queries sorted by timeline position
    qpos = sel[ord_q]
    n_all = m_f.shape[0]
    D = Ps.shape[-1]
    eye = torch.eye(D, dtype=Ps.dtype, device=Ps.device)
    Gpad = torch.cat([Gs, eye[None]], dim=0)  # G_k links k → k+1
    is_q = set(qpos.tolist())
    U, prods = eye, []
    for k in range(n_all):
        prods.append(U)  # ∏_{t=lastq(k)}^{k−1} G_t (carry at entrance of step k)
        U = Gpad[k] if k in is_q else U @ Gpad[k]  # reset the chain at queries
    segs = torch.stack(prods)[qpos][1:]  # (M−1, D, D) between-query products
    Fq = _pairwise_fcov(H, segs, Ps[qpos])
    inv_q = torch.argsort(ord_q)
    return mean_s[sel], Fq[inv_q][:, inv_q]


class MarkovPosteriorGP(AbstractGP):
    """Exact GPR posterior served by the state-space backend.

    Same semantics as the dense ``posterior(fx, y)`` for Markov kernels on
    1-D inputs, but nothing N×N over the TRAINING set is ever formed:
    marginals come from the O(N·p³) filter/smoother, and cross-covariances
    between query points from the smoother gains (the smoothed chain is
    Gauss–Markov, so ``Cov(f(t_i), f(t_j)) = Hᵀ G_i … G_{j−1} P_j^s H``).
    Being an ``AbstractGP``, it composes with projection, further
    conditioning and the conformance suites. ``cov`` between M query points
    costs O((N+M)·p³ + M²·p³).
    """

    def __init__(self, fx, y, parallel: bool = False):
        self.fx = fx
        self.y = y
        self.parallel = parallel

    def mean(self, xs):
        return markov_mean_and_var(self.fx, self.y, xs, self.parallel)[0]

    def var(self, xs):
        return markov_mean_and_var(self.fx, self.y, xs, self.parallel)[1]

    def mean_and_var(self, xs):
        return markov_mean_and_var(self.fx, self.y, xs, self.parallel)

    def cov(self, xs, zs=None):
        if zs is None:
            return _posterior_joint(self.fx, self.y, xs, self.parallel)[1]
        # cross-cov via the joint (nx+nz)² query table, slicing the cross
        # block (the training-set pass, the O(N) part, is shared either way)
        xq, zq = as_inputs(xs), as_inputs(zs)
        nx = xq.shape[0]
        tq = torch.cat([xq, zq.to(dtype=xq.dtype, device=xq.device)], dim=0)
        F = _posterior_joint(self.fx, self.y, tq, self.parallel)[1]
        return F[:nx, nx:]

    def mean_and_cov(self, xs):
        return _posterior_joint(self.fx, self.y, xs, self.parallel)

    def rand(self, generator, xs, num_samples=None):
        """Joint posterior samples at ``xs`` via the O(N) backward sampler
        (``markov_rand``), not the dense covariance."""
        return markov_rand(self.fx, self.y, xs, generator, num_samples=num_samples,
                           parallel=self.parallel)


def markov_posterior(fx, y, parallel: bool = False) -> MarkovPosteriorGP:
    """``posterior(fx, y)`` on the state-space path: an ``AbstractGP`` with
    O(N·p³) training cost (see ``MarkovPosteriorGP``)."""
    if not is_markov_kernel(fx.f.kernel):
        raise TypeError(
            f"kernel {type(fx.f.kernel).__name__} has no state-space form; "
            "markov_posterior supports Matern-family kernels (and sums) on "
            "1-D inputs"
        )
    return MarkovPosteriorGP(fx, as_tensor(y, device=as_inputs(fx.x).device), parallel)
