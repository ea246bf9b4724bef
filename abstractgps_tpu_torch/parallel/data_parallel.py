"""Data-parallel sharded objectives and training steps.

Counterpart of the JAX package's ``parallel/data_parallel.py``: training
data is sharded along a mesh axis (``"dp"``), hyperparameters are
replicated, and the cross-shard sums are all-reduces.

The collapsed Titsias ELBO (src/sparse_approximations.jl:289-305)
distributes over data shards: with ``A = L_z⁻¹ Kzx Σy^{-1/2}`` sharded over
its columns, its statistics are sums over the shards,

    A·Aᵀ = Σ_s A_s A_sᵀ (m × m),   A·δ = Σ_s A_s δ_s (m),   ‖δ‖² = Σ_s ‖δ_s‖²,

with log|Σy|, tr(Σy⁻¹ diag K), ‖A‖²_F and n likewise, so a step moves
O(m²) bytes whatever N is. In JAX the same call on sharded inputs gives
the global ELBO because XLA inserts the ``psum``s. In the port,
``fit_sharded`` activates the data axis (``collectives.data_axis``), and
``models.sparse`` then sums those statistics with one packed
differentiable all-reduce (``psum``); every rank forms ``L_z`` and
``L_Λ`` from the same sums. Outside ``fit_sharded`` nothing changes.

A loss of one's own takes the same context by calling ``psum`` on its
shard-additive terms (a mean over the data: ``psum(sum, count)``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from .. import params as P
from .collectives import all_reduce, data_axis, psum
from .mesh import axis_rank, replicate, shard_along

__all__ = ["fit_sharded", "ShardedFitResult", "psum"]


class ShardedFitResult(NamedTuple):
    params: object          # replicated: every rank holds the same tree
    history: torch.Tensor   # the global loss before each step


def _shard_tree(tree, mesh, axis):
    if isinstance(tree, dict):
        return {k: _shard_tree(v, mesh, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shard_tree(v, mesh, axis) for v in tree)
    return shard_along(tree, mesh, axis) if isinstance(tree, torch.Tensor) else tree


def fit_sharded(loss: Callable, theta0, data, mesh: DeviceMesh, *, axis: str = "dp",
                optimizer: Callable | None = None, num_steps: int = 500,
                learning_rate: float = 1e-2) -> ShardedFitResult:
    """Minimise ``loss(raw_theta, data)`` with ``data`` sharded over ``axis``.

    ``data`` is a tree (dicts, lists, tuples) of tensors whose leading
    dimension is the data dimension; each rank keeps its block
    (``shard_along``; the leading dimension must divide by the axis size).
    ``theta0`` (a tagged parameter tree, as ``fit`` takes) is replicated
    from the mesh's first rank. ``optimizer(leaves)`` builds a
    ``torch.optim`` optimizer (default ``torch.optim.Adam(leaves,
    lr=learning_rate)``, the update of ``optax.adam``). The gradients are
    averaged over the axis before each step, so every rank takes the same
    step and θ stays replicated. ``history[i]`` is the global loss before
    step i.

    Inside, the collapsed bounds (``elbo``, DTC's evidence) sum over the
    shards that the loss passes them and raise on data that is no shard
    (``collectives.data_psum``); a bound of replicated data is computed
    inside ``collectives.data_axis(None)``. Every other objective (the exact
    logpdf, SVGP's ELBO, ``posterior``) sees this rank's shard only: a loss
    built on one sums its terms with ``psum``.
    """
    _, w = axis_rank(mesh, axis)
    group = mesh.get_group(axis)
    data = _shard_tree(data, mesh, axis)
    theta = replicate(theta0, mesh)  # new leaves, as fit's copy
    for t in P.leaves(theta):
        t.requires_grad_()
    leaves = P.leaves(theta)
    opt = (optimizer or (lambda ps: torch.optim.Adam(ps, lr=learning_rate)))(leaves)
    history = torch.full((num_steps,), float("nan"), dtype=leaves[0].dtype,
                         device=leaves[0].device)
    with data_axis(group):
        for i in range(num_steps):
            opt.zero_grad(set_to_none=True)
            val = loss(theta, data)
            val.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
            flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group) / w
            j = 0
            for p in leaves:
                p.grad = flat[j:j + p.numel()].reshape(p.shape).to(p.dtype)
                j += p.numel()
            opt.step()
            history[i] = val.detach()
    return ShardedFitResult(theta, history)
