"""The parallel layer's collectives, its data-axis context and its counter.

Where the JAX package lets GSPMD insert a ``psum`` wherever a reduction
meets a sharded operand, the port sums explicitly: while ``data_axis``
names a process group (``fit_sharded`` sets it), ``psum`` all-reduces its
tensors over that group in one packed call, and outside it ``psum`` is the
identity, so a single-process call takes no collective. A model's own
sums over its data (the collapsed bounds) go through ``data_psum``, which
sums only data that ``mesh.shard_along`` marked as a shard of the active
axis and raises on any other data inside the axis, so a replicated input
is never counted once a rank. The sum is
differentiable: its backward all-reduces the cotangents, so each rank's
backward carries W times its own shard's term plus the replicated terms
once, and the replicated parameters' gradients are then averaged over the
ranks (``fit_sharded``), which gives exactly the global gradient.

The tensor-parallel sweep (``sharded_linalg``) moves blocks between ranks
with ``all_gather`` and ``broadcast_from``, both differentiable by their
exact adjoints: the backward sums the cotangents of every rank's copy
(one all-reduce) and hands the source its part. Its replicated inputs go
through ``replicated``, whose backward averages their cotangents over the
ranks, so that every rank gets the global gradient.

Every collective of the layer goes through this module and adds to
``COLLECTIVES`` (calls) and ``COLLECTIVE_BYTES`` (bytes this rank sends in:
the tensor's size), the eager counterpart of counting collective ops in a
compiled program; a backward's all-reduce counts as one.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVES", "COLLECTIVE_BYTES", "reset_collectives", "all_reduce", "all_gather",
           "broadcast", "broadcast_from", "replicated", "data_axis", "active_axis", "psum",
           "mark_shard", "data_psum"]

COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
COLLECTIVE_BYTES = dict.fromkeys(COLLECTIVES, 0)

_AXIS = []  # the stack of active data-axis process groups
_SHARD_OF = "_parallel_shard_of"  # the attribute a shard carries: its group's ranks


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0
        COLLECTIVE_BYTES[k] = 0


def _count(name: str, t: torch.Tensor) -> None:
    COLLECTIVES[name] += 1
    COLLECTIVE_BYTES[name] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no autograd); returns ``t``."""
    _count("all_reduce", t)
    dist.all_reduce(t, group=group)
    return t


class _AllGather(torch.autograd.Function):
    """Every rank's block, concatenated; the backward all-reduces the
    cotangent and keeps this rank's block (gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, group, t):
        t = t.contiguous()
        ctx.group, ctx.rows = group, t.shape[0]
        ctx.rank = dist.get_rank(group)
        outs = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        _count("all_gather", t)
        dist.all_gather(outs, t, group=group)
        return torch.cat(outs)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.group)
        return None, g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank) concatenated along dim
    0, in group-rank order; differentiable."""
    return _AllGather.apply(group, t)


def _global_rank(group, src: int) -> int:
    return src if group is None else dist.get_global_rank(group, src)


def broadcast(t: torch.Tensor, group=None, src: int = 0) -> torch.Tensor:
    """``t`` of group rank ``src``, written in place on every rank (no
    autograd); returns ``t``."""
    _count("broadcast", t)
    dist.broadcast(t, src=_global_rank(group, src), group=group)
    return t


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, src, t, *after):
        ctx.group, ctx.mine = group, dist.get_rank(group) == src
        return broadcast(t.detach().contiguous().clone(), group, src)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.group)
        return (None, None, g if ctx.mine else None) + (None,) * len(ctx.needs_input_grad[3:])


def broadcast_from(t: torch.Tensor, src: int, group=None, after=()) -> torch.Tensor:
    """A new tensor holding group rank ``src``'s ``t`` on every rank (the
    others pass any tensor of its shape and dtype; its values are not
    read). Differentiable: the backward sums every rank's cotangent into
    ``src``'s ``t``. ``after`` are tensors of this rank's graph that the
    result is made to depend on: a rank other than ``src`` often holds no
    input of its own that requires grad, and without them its backward
    would never reach this collective, or reach it in another order than
    ``src``'s."""
    return _BroadcastFrom.apply(group, src, t, *after)


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks; the backward sums the cotangents over the ranks."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        return all_reduce(t.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return None, all_reduce(g.detach().clone(), ctx.group)


class _Replicated(torch.autograd.Function):
    """The identity; the backward averages the cotangents over the ranks."""

    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(t.clone() for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        dev = gs[0].device
        dtype = functools.reduce(torch.promote_types, (g.dtype for g in gs))
        flat = all_reduce(torch.cat([g.reshape(-1).to(dev, dtype) for g in gs]), ctx.group)
        flat = flat / dist.get_world_size(ctx.group)
        out, i = [], 0
        for g in gs:
            out.append(flat[i:i + g.numel()].reshape(g.shape).to(g.device, g.dtype))
            i += g.numel()
        return (None, *out)


def replicated(group, *tensors):
    """The tensors, which every rank of ``group`` holds alike, as the inputs
    of one computation spread over the ranks (a tuple of copies). The
    backward averages their cotangents over the ranks in one packed
    all-reduce: where the spread computation's collectives carry their exact
    adjoints and every rank seeds its copy of the replicated result, the
    ranks' cotangents sum to W times the gradient, so every rank gets the
    gradient itself."""
    return _Replicated.apply(group, *tensors)


@contextlib.contextmanager
def data_axis(group):
    """Within the block, ``psum`` sums over ``group`` (a process group whose
    ranks each hold one shard of the data). ``data_axis(None)`` marks a
    block of replicated data inside it: there ``psum`` is the identity."""
    _AXIS.append(group)
    try:
        yield group
    finally:
        _AXIS.pop()


def active_axis():
    """The innermost active data-axis group, or None."""
    return _AXIS[-1] if _AXIS else None


def psum(*tensors):
    """The tensors summed over the active data axis, in one packed
    differentiable all-reduce; the tensors themselves when no axis is
    active. Returns a tuple."""
    group = active_axis()
    if group is None:
        return tensors
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    total = _AllReduceSum.apply(group, flat)
    out, i = [], 0
    for t in tensors:
        out.append(total[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return tuple(out)


def mark_shard(t: torch.Tensor, group) -> torch.Tensor:
    """Mark ``t`` as this rank's shard of data sharded over ``group``;
    returns ``t``."""
    setattr(t, _SHARD_OF, tuple(dist.get_process_group_ranks(group)))
    return t


def data_psum(data, *tensors):
    """``psum`` of a model's sums over its ``data`` (a sequence of its input
    tensors): summed over the active data axis when one of ``data`` is a
    shard of it (``mark_shard``, as ``mesh.shard_along`` and
    ``host_local_array`` give it), the tensors themselves when no axis is
    active. Inside an active axis, data that is no shard of it raises: the
    sum would count a replicated input once a rank, and a tensor derived
    from a shard inside the loss has lost its mark."""
    group = active_axis()
    if group is None:
        return tensors
    ranks = tuple(dist.get_process_group_ranks(group))
    if not any(getattr(d, _SHARD_OF, None) == ranks for d in data):
        raise ValueError(
            "a data-axis sum (fit_sharded, collectives.data_axis) was given data that is "
            "not a shard of that axis: pass the shards that shard_along or fit_sharded "
            "give, or compute a bound of replicated data inside "
            "collectives.data_axis(None)")
    return psum(*tensors)
