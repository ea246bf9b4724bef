"""Tensor-parallel (TP) sharded gram and distributed blocked Cholesky.

Counterpart of the JAX package's ``parallel/sharded_linalg.py``: exact GP
regression past one device's memory. The N×N gram is block-cyclically
row-sharded over a mesh axis and factorized by a right-looking distributed
Cholesky, one panel at a time.

Layout. With W ranks on axis ``tp``, panel width B and padded size
``Np = nb·B`` (``nb % W == 0``), global row block ``g`` lives on rank
``g % W`` at local slot ``g // W``: 1-D block-cyclic, which keeps the
trailing-update work balanced as the factorization shrinks.

Per panel ``k`` (a Python loop; each rank holds only its trailing rows and
columns, the rows of global block ≥ k and the columns ≥ k·B):

1. the owner (``k % W``) sends its diagonal block, with its rows of the
   right-hand side when there is one, to every rank in one collective
   (``broadcast_from``); every rank factors the B×B block itself
   (``cholesky_ex``, no host sync; a block that is not positive definite
   gives NaN, as ``lax.linalg.cholesky`` does) and inverts it;
2. each rank forms its panel rows below the block, ``L21 = A[:, k]·L_kk⁻ᵀ``;
3. ``all_gather`` of the panel column in global row order, the one O(N)
   collective (each rank sends its trailing rows only, padded to the
   longest rank's count);
4. the trailing update ``A[k+1:, k+1:] -= L21·P[k+1:]ᵀ`` on this rank's
   trailing rows and columns only. The JAX body multiplies full-width
   masked blocks so that its compiled loop keeps one shape; the entries are
   the same (the masks subtracted exact zeros) at about a third of the
   FLOPs at W = 2.

The right-hand side ``δ = y − m`` (and, for prediction, ``K(X, x*)``) rides
the sweep as extra columns, forward-substituted panel by panel, so the
logdet and the Mahalanobis term come out of the factorization. Each rank
builds only its own rows of the gram from the replicated inputs (on the
card at f32, ``gram_tile``); the noise diagonal is added to each diagonal
block as it is factored. Every product runs at IEEE f32 (``full_f32``),
never TF32.

Gradients. The collectives carry their exact adjoints (the backward of the
broadcast and of the gather sums the ranks' cotangents, one all-reduce
each), and the replicated inputs (x, y, x*, the noise diagonal and the
hyperparameter tensors of the prior's kernel and mean, as
``kernels.base.hyperparameters`` lists them) enter through
``collectives.replicated``, whose backward averages their cotangents over
the ranks. So every rank seeds its own copy of the replicated result, and
every rank gets the global gradient, equal to the unsharded one: a
``fit`` of a sharded loss takes the same step on every rank. A tensor
that a kernel reaches by other ways (a closure) gets only this rank's
share. The backward saves each panel's gathered column (Np²/2 floats a
rank over the sweep) and runs at torch's global matmul flags.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..kernels.base import Kernel, hyperparameters, kernelmatrix, substituted_hyperparameters
from ..ops.distance import as_inputs, as_tensor
from ..ops.precision import full_f32
from .collectives import all_gather, broadcast_from, mark_shard, replicated
from .mesh import axis_rank, local_block

__all__ = [
    "sharded_gram",
    "distributed_cholesky",
    "sharded_logpdf",
    "sharded_mean_and_var",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _padded_size(n: int, block: int, ndev: int) -> int:
    chunk = block * ndev
    return ((n + chunk - 1) // chunk) * chunk


def sharded_gram(kernel: Kernel, x, mesh: DeviceMesh, axis: str = "tp") -> torch.Tensor:
    """This rank's contiguous row block of ``kernelmatrix(kernel, x)``,
    ``k(x[lo:hi], x)`` (``mesh.shard_along``'s block; never gathered),
    marked as a shard of ``axis``. On the card at f32 it is one
    ``gram_tile``."""
    x = as_inputs(x)
    lo, hi = local_block(x.shape[0], mesh, axis)
    return mark_shard(kernelmatrix(kernel, x[lo:hi], x), mesh.get_group(axis))


def _local_rows(nb_local: int, block: int, ndev: int, d: int, device) -> torch.Tensor:
    """Global row indices held by rank ``d`` (block-cyclic), ascending."""
    blk = torch.arange(nb_local, device=device) * ndev + d
    return (blk[:, None] * block + torch.arange(block, device=device)[None, :]).reshape(-1)


def _reorder_gather(parts: torch.Tensor, nb_local: int, block: int, ndev: int) -> torch.Tensor:
    """(W·S, c) all_gather output, each rank's ``nb_local`` slots of
    ``block`` rows, → the same rows in global order."""
    width = parts.shape[1]
    return (parts.reshape(ndev, nb_local, block, width).transpose(0, 1)
            .reshape(ndev * nb_local * block, width))


def _factorize_slab(A_loc, rhs_loc, diag, *, nb, block, ndev, rank, group, want_factor=False):
    """The distributed sweep over this rank's block-cyclic row slab.

    ``A_loc`` (S, Np): this rank's rows of the padded SPD matrix, without
    ``diag`` (Np,), which is added to each diagonal block as it is factored.
    ``rhs_loc`` (S, q) or None: this rank's rows of the
    right-hand sides. Returns ``(L_loc, logdet, z)``: this rank's rows of the
    lower factor when ``want_factor`` (zeros above the diagonal) else None,
    log|L| summed over the diagonal, and ``z = L⁻¹·rhs`` (Np, q), replicated
    (None without a right-hand side). Holds only the trailing rows and
    columns, so ``A_loc`` is freed after the first panel when the caller
    keeps no reference."""
    B, W, d = block, ndev, rank
    nb_local = nb // W
    S = A_loc.shape[0]
    T, R = A_loc, rhs_loc  # rows of global block ≥ k, columns ≥ k·B
    del A_loc, rhs_loc
    q = 0 if R is None else R.shape[1]
    eye = torch.eye(B, dtype=T.dtype, device=T.device)
    nan = torch.full((), float("nan"), dtype=T.dtype, device=T.device)
    logdet = torch.zeros((), dtype=T.dtype, device=T.device)
    zs, cols = [], []
    for k in range(nb):
        owner = k % W
        mine = d == owner
        # 1. the owner's diagonal block and right-hand-side rows, to every rank
        if mine:
            blk = T[:B, :B] if R is None else torch.cat([T[:B, :B], R[:B]], dim=1)
        else:
            blk = T.new_empty((B, B + q))
        if W > 1:
            blk = broadcast_from(blk, owner, group, after=(T,) if R is None else (T, R))
        L, info = torch.linalg.cholesky_ex(blk[:, :B] + torch.diag(diag[k * B:(k + 1) * B]))
        Lkk = torch.where(info == 0, L, nan)
        invT = torch.linalg.solve_triangular(Lkk, eye, upper=False).T
        logdet = logdet + torch.log(torch.diagonal(Lkk)).sum()
        # 2. this rank's panel rows below the diagonal block
        below = T[B:] if mine else T
        pan = below[:, :B]
        if pan.requires_grad:
            pan = pan.clone()  # the matmul saves it: a view would keep the slab alive
        L21 = pan @ invT
        if R is not None:
            zk = torch.linalg.solve_triangular(Lkk, blk[:, B:], upper=False)
            zs.append(zk)
            R = (R[B:] if mine else R) - L21 @ zk
        if want_factor:
            col = torch.cat([Lkk, L21]) if mine else L21
            cols.append(F.pad(col, (0, 0, S - col.shape[0], 0)))
        # 3. the panel column in global row order, then 4. the trailing update
        first = (k + 1) // W  # first local slot any rank still holds
        c = nb_local - first
        if c == 0:
            break
        if W > 1:
            part = F.pad(L21, (0, 0, c * B - L21.shape[0], 0))
            P = _reorder_gather(all_gather(part, group), c, B, W)[(k + 1 - first * W) * B:]
        else:
            P = L21
        T = torch.addmm(below[:, B:], L21, P.T, alpha=-1.0)
    L_loc = torch.cat(cols, dim=1) if want_factor else None
    z = torch.cat(zs) if zs else None
    return L_loc, logdet, z


@contextlib.contextmanager
def _replicated_inputs(prior, group, ndev: int, *tensors):
    """Within the block, the prior's kernel and mean read their
    hyperparameter tensors through ``collectives.replicated`` and the
    ``tensors`` are yielded through it (those that require grad; the
    others, and everything outside a grad-enabled multi-rank call, pass
    as they are)."""
    mods = [] if prior is None else [prior.kernel, prior.mean_fn]
    need = {}
    if ndev > 1 and torch.is_grad_enabled():
        for t in [h for m in mods for h in hyperparameters(m)] + list(tensors):
            if t.requires_grad:
                need.setdefault(id(t), t)
    if not need:
        yield tensors
        return
    tied = dict(zip(need, replicated(group, *need.values())))

    def sub(t):
        return tied.get(id(t), t)

    with contextlib.ExitStack() as stack:
        for m in mods:
            stack.enter_context(substituted_hyperparameters(m, sub))
        yield tuple(sub(t) for t in tensors)


def _layout(n, mesh, axis, block):
    rank, ndev = axis_rank(mesh, axis)
    npad = _padded_size(n, block, ndev)
    nb = npad // block
    return rank, ndev, mesh.get_group(axis), npad, nb


def _rows(n, nb, block, ndev, rank, device):
    """This rank's global rows, and how many of them are real (< n): the
    padding is the last global rows, so a suffix of each rank's."""
    rows = _local_rows(nb // ndev, block, ndev, rank, device)
    n_real = sum(min(block, max(0, n - (j * ndev + rank) * block)) for j in range(nb // ndev))
    return rows, n_real


def _gram_rows(kernel, x, z, rows, n_real, shape):
    """``k(x[rows], z)`` for this rank's real rows, zero-padded to
    ``shape`` (padding rows below, padding columns right)."""
    K = kernelmatrix(kernel, x[rows[:n_real]], z)
    if tuple(K.shape) != shape:
        K = F.pad(K, (0, shape[1] - K.shape[1], 0, shape[0] - K.shape[0]))
    return K


def _check_noise(fx, name, alternative):
    from ..ops.noise import DenseNoise

    if isinstance(fx.noise, DenseNoise):
        raise NotImplementedError(
            f"{name} supports isotropic/diagonal noise only; a dense (correlated) noise "
            f"covariance would be silently truncated to its diagonal. Use {alternative} for "
            "DenseNoise.")


def distributed_cholesky(A: torch.Tensor, mesh: DeviceMesh, axis: str = "tp",
                         block: int = 256) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``A`` by the distributed sweep, the
    whole factor on every rank: ``cholesky(A)`` (src/util/common_covmat_ops.jl:
    12-15) on a W-rank mesh axis.

    The test and oracle wrapper around the sweep: it takes the whole (n, n)
    matrix on every rank, keeps this rank's block-cyclic rows, and gathers
    the factor back in natural order, so it does not itself scale past one
    device's memory; ``sharded_logpdf`` is the scalable path."""
    A = as_tensor(A)
    n = A.shape[-1]
    rank, ndev, group, npad, nb = _layout(n, mesh, axis, block)
    with _replicated_inputs(None, group, ndev, A) as (A,):
        A = F.pad(A, (0, npad - n, 0, npad - n))
        diag = F.pad(A.new_zeros(n), (0, npad - n), value=1.0)  # identity on the padding
        rows = _local_rows(nb // ndev, block, ndev, rank, A.device)
        with full_f32():
            L_loc, _, _ = _factorize_slab(A[rows], None, diag, nb=nb, block=block, ndev=ndev,
                                          rank=rank, group=group, want_factor=True)
            if ndev > 1:
                L_loc = _reorder_gather(all_gather(L_loc, group), nb // ndev, block, ndev)
    return torch.tril(L_loc)[:n, :n]


def sharded_logpdf(fx, y, mesh: DeviceMesh, axis: str = "tp", block: int = 256) -> torch.Tensor:
    """Exact log marginal likelihood with the N×N gram sharded over ``axis``.

    ``logpdf(fx, y)`` (src/finite_gp_projection.jl:306-311) of a ``GP``-prior
    FiniteGP with isotropic or diagonal noise, at scale: each rank builds
    only its block-cyclic rows of ``K + Σy`` from the replicated inputs, the
    distributed sweep factorizes them, and ``δ = y − m`` forward-substitutes
    through the same sweep. Nothing N×N exists on one rank (a rank holds
    ~Np²/W floats, twice that during a panel's update).

    ``y`` may be (n,) → a scalar, or (n, q) → (q,) column-wise log-densities,
    the extra columns riding the same sweep. Every rank returns the same
    value; its gradient is the global one on every rank (the module's
    rule). A dense (correlated) noise raises ``NotImplementedError``: the
    sweep reads only the noise diagonal.
    """
    _check_noise(fx, "sharded_logpdf", "fx.logpdf(y)")
    prior, x = fx.f, fx.x
    n = x.shape[0]
    y = as_tensor(y)
    if y.ndim not in (1, 2) or y.shape[0] != n:
        raise ValueError(f"y must be (n,) or (n, q) with n={n}; got shape {tuple(y.shape)}")
    rank, ndev, group, npad, nb = _layout(n, mesh, axis, block)
    y_vec = y.ndim == 1
    with _replicated_inputs(prior, group, ndev, x, y, fx.noise.diag()) as (x, y, nd):
        Y = y[:, None] if y_vec else y
        delta = Y - prior.mean(x)[:, None]
        dtype = delta.dtype
        rows, n_real = _rows(n, nb, block, ndev, rank, x.device)
        diag = F.pad(nd.to(device=x.device, dtype=dtype), (0, npad - n), value=1.0)
        rhs = F.pad(delta, (0, 0, 0, npad - n))[rows]
        with full_f32():
            _, logdet, z = _factorize_slab(
                _gram_rows(prior.kernel, x, x, rows, n_real, (rows.shape[0], npad)).to(dtype),
                rhs, diag, nb=nb, block=block, ndev=ndev, rank=rank, group=group)
        out = -0.5 * (n * _LOG_2PI + 2.0 * logdet + (z * z).sum(0))
    return out[0] if y_vec else out


def sharded_mean_and_var(fx, y, x_test, mesh: DeviceMesh, axis: str = "tp", block: int = 256,
                         test_chunk: int = 4096):
    """Exact posterior-predictive marginals with the train gram sharded.

    ``posterior(fx, y).mean_and_var(x_test)`` (src/exact_gpr_posterior.jl:
    85-90) at TP scale, by whitened prediction: the sweep runs with the
    right-hand side ``[δ | K(X, x*)]``, whose forward substitution gives
    ``z_δ = L⁻¹δ`` and ``Z = L⁻¹K(X, x*)``, so

        mean = m(x*) + Zᵀz_δ,     var = max(k**_diag − colsums(Z²), 0)

    with no backward solve and nothing N×N or N×M on one rank: each rank
    builds its rows of the train gram and of ``K(X, x*)``. ``y`` may be (n,)
    or (n, q) (the mean is then (M, q)). Test sets larger than
    ``test_chunk`` are chunked, each chunk a sweep of its own (a rank's
    right-hand side is (Np/W)·(q + test_chunk) floats). The noise as in
    ``sharded_logpdf``; the gradient rule is the module's.
    """
    _check_noise(fx, "sharded_mean_and_var", "posterior(fx, y).mean_and_var(x_test)")
    prior, x = fx.f, fx.x
    xt = as_inputs(x_test)
    if xt.shape[0] > test_chunk:
        parts = [sharded_mean_and_var(fx, y, xt[s:s + test_chunk], mesh, axis=axis,
                                      block=block, test_chunk=test_chunk)
                 for s in range(0, xt.shape[0], test_chunk)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    n, m_test = x.shape[0], xt.shape[0]
    y = as_tensor(y)
    if y.shape[0] != n or y.ndim > 2:
        raise ValueError(f"y must be (n,) or (n, q) with n={n}; got {tuple(y.shape)}")
    rank, ndev, group, npad, nb = _layout(n, mesh, axis, block)
    y_vec = y.ndim == 1
    q = 1 if y_vec else y.shape[1]
    with _replicated_inputs(prior, group, ndev, x, y, fx.noise.diag(), xt) as (x, y, nd, xt):
        m = prior.mean(x)
        delta = (y - m)[:, None] if y_vec else y - m[:, None]
        dtype = delta.dtype
        rows, n_real = _rows(n, nb, block, ndev, rank, x.device)
        S = rows.shape[0]
        diag = F.pad(nd.to(device=x.device, dtype=dtype), (0, npad - n), value=1.0)
        rhs = torch.cat([F.pad(delta, (0, 0, 0, npad - n))[rows],
                         _gram_rows(prior.kernel, x, xt, rows, n_real, (S, m_test)).to(dtype)],
                        dim=1)
        with full_f32():
            _, _, z = _factorize_slab(
                _gram_rows(prior.kernel, x, x, rows, n_real, (S, npad)).to(dtype), rhs, diag,
                nb=nb, block=block, ndev=ndev, rank=rank, group=group)
            Z = z[:, q:]
            mean_c = Z.T @ z[:, :q]
        var_red = (Z * Z).sum(0)
        mt = prior.mean(xt)
        mean = mt + mean_c[:, 0] if y_vec else mt[:, None] + mean_c
        var = torch.clamp_min(prior.var(xt) - var_red, 0.0)
    return mean, var
