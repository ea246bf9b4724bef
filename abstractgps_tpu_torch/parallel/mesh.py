"""Device-mesh utilities for SPMD GP inference over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, one rank per device (gloo on the CPU; NCCL on the card, one rank per
GPU), with named axes:

- ``"dp"`` — data parallel: training points for the sharded ELBO, chains
  for NUTS/HMC/ESS, particles for SMC;
- ``"tp"`` — tensor parallel: block-sharded linear algebra.

A shard is a plain tensor, this rank's contiguous block along one
dimension: the port's autograd Functions and CUDA kernels take plain
tensors, and a DTensor has no rule for a Cholesky. A process with no
process group (a plain script) runs as a world of one.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .collectives import broadcast, mark_shard

__all__ = ["make_mesh", "shard_along", "replicate", "axis_rank", "local_block"]


def _ensure_group() -> None:
    """A world of one (gloo over an in-memory store) when no process group
    exists."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _build(shape, axis_names) -> DeviceMesh:
    return init_device_mesh(_mesh_device_type(), tuple(shape), mesh_dim_names=tuple(axis_names))


def make_mesh(n_devices: int | None = None, axis_names: tuple[str, ...] = ("dp",),
              shape: tuple[int, ...] | None = None) -> DeviceMesh:
    """A mesh over the process group's ranks. ``shape`` splits them over
    several named axes, e.g. ``make_mesh(4, ("dp", "tp"), (2, 2))``; the
    default is one axis holding every rank. A mesh spans every rank of the
    process group, so ``n_devices`` (default: the world size) must equal it."""
    _ensure_group()
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if shape is None:
        shape = (n_devices,)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} does not match axis_names {axis_names}")
    if math.prod(shape) != n_devices:
        raise ValueError(f"shape {shape} does not use exactly {n_devices} devices")
    if n_devices != world:
        raise ValueError(f"a mesh spans every rank of the process group: {n_devices} "
                         f"devices requested, world size {world}")
    return _build(shape, axis_names)


def axis_rank(mesh: DeviceMesh, axis: str) -> tuple[int, int]:
    """(this rank's index along ``axis``, the axis size)."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {mesh.mesh_dim_names}")
    i = mesh.mesh_dim_names.index(axis)
    return mesh.get_local_rank(i), mesh.size(i)


def local_block(n: int, mesh: DeviceMesh, axis: str) -> tuple[int, int]:
    """(start, stop) of this rank's contiguous block of ``n`` rows sharded
    over ``axis``; ``n`` must divide by the axis size."""
    r, w = axis_rank(mesh, axis)
    if n % w:
        raise ValueError(f"dimension of size {n} does not divide the mesh axis {axis!r} "
                         f"of size {w} (pad at the call site)")
    b = n // w
    return r * b, (r + 1) * b


def shard_along(x: torch.Tensor, mesh: DeviceMesh, axis: str = "dp", dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim``: the rows that
    device r of the JAX package's ``NamedSharding(mesh, P(axis))`` holds,
    marked as a shard of the axis (``collectives.data_psum``).
    ``x.shape[dim]`` must divide by the axis size."""
    lo, hi = local_block(x.shape[dim], mesh, axis)
    return mark_shard(x.narrow(dim, lo, hi - lo), mesh.get_group(axis))


def replicate(tree, mesh: DeviceMesh):
    """Every tensor leaf of a tree (dicts, lists, tuples, parameter tags)
    as the mesh's first rank holds it, broadcast to every rank (a mesh
    spans the whole process group); the leaves are new tensors."""
    from ..params import leaves, with_leaves

    out = []
    for t in leaves(tree):
        c = broadcast(t.detach().clone())
        out.append(c.requires_grad_(t.requires_grad))
    return with_leaves(tree, out)
