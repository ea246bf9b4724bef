"""The mBCG loop as it ran before it learnt to stop: exactly ``max_iters``
steps, every one a matvec, the frozen columns' steps recording α = β = 0.
The early-exit tests hold ``models.iterative.mbcg`` to it bit for bit.
Plain torch; no JAX, no conftest."""

import torch


@torch.no_grad()
def fixed_trip_mbcg(matvec, B, *, max_iters, tol=None, precond=None):
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
    for _ in range(max_iters):
        KP = matvec(P)
        pKp = torch.sum(P * KP, dim=0)
        active = active & (pKp > 0)
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
    return X, (torch.stack(alphas), torch.stack(betas), torch.stack(actives))


def assert_bitwise(got, want):
    """Two ``mbcg`` results equal in shape, dtype and every bit."""
    (X, coeffs), (X0, coeffs0) = got, want
    for a, b in zip((X, *coeffs), (X0, *coeffs0)):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        assert torch.equal(a, b)
        if a.is_floating_point():  # torch.equal holds -0 == +0
            assert torch.equal(torch.signbit(a), torch.signbit(b))
