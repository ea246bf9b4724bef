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

Every collective of the layer goes through this module and adds to
``COLLECTIVES`` (calls) and ``COLLECTIVE_BYTES`` (bytes this rank sends in:
the tensor's size), the eager counterpart of counting collective ops in a
compiled program.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVES", "COLLECTIVE_BYTES", "reset_collectives", "all_reduce", "all_gather",
           "broadcast", "data_axis", "active_axis", "psum", "mark_shard", "data_psum"]

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


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in group-rank order."""
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _count("all_gather", t)
    dist.all_gather(outs, t, group=group)
    return torch.cat(outs)


def broadcast(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` of the group's first rank, written in place on every rank."""
    src = 0 if group is None else dist.get_global_rank(group, 0)
    _count("broadcast", t)
    dist.broadcast(t, src=src, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks; the backward sums the cotangents over the ranks."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        return all_reduce(t.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return None, all_reduce(g.detach().clone(), ctx.group)


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
