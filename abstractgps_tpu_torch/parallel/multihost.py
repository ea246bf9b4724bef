"""Multi-process runtime: ``torch.distributed`` wiring and host-aware meshes.

Counterpart of the JAX package's ``parallel/multihost.py``. One process per
device joins one process group. ``initialize_distributed`` reads torch's
launcher variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, as ``torchrun`` sets
them) or takes them as arguments, and is a no-op in a single process, so
the same script runs unmodified on one device. The backend is NCCL when
every rank of a host has a GPU of its own, and gloo otherwise (the CPU, or
more ranks than cards: NCCL refuses two ranks on one GPU, while gloo's
all-reduce and broadcast take CUDA tensors).

``make_pod_mesh`` puts ``dp`` across hosts and ``tp`` within a host, by a
process-major reshape of the ranks (torchrun numbers them host by host).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.distance import resolve_device
from .collectives import mark_shard
from .mesh import _build, _ensure_group, axis_rank, make_mesh

__all__ = [
    "initialize_distributed",
    "is_distributed",
    "make_pod_mesh",
    "host_local_array",
    "process_index",
    "num_processes",
]


def _env_int(name: str):
    v = os.environ.get(name)
    return None if v is None else int(v)


def _local_world(world: int) -> int:
    """Ranks per host: ``LOCAL_WORLD_SIZE``, else every rank on this host."""
    return _env_int("LOCAL_WORLD_SIZE") or world


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, local_rank: int | None = None, *,
                           timeout: float | None = None) -> None:
    """Join the process group (idempotent; a no-op in a single process).

    ``init_method`` is a torch rendezvous URL (``"tcp://host:port"``,
    ``"file:///path"``); by default ``"env://"`` when ``MASTER_ADDR`` is set.
    ``world_size``, ``rank`` and ``local_rank`` default to ``WORLD_SIZE``,
    ``RANK`` and ``LOCAL_RANK``. ``timeout`` (seconds) bounds every
    collective, so a dead peer fails the run instead of hanging it.
    """
    if dist.is_initialized():
        return
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and world_size is None:
        return  # a single process: nothing to join
    local_rank = local_rank if local_rank is not None else (_env_int("LOCAL_RANK") or 0)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if cards >= _local_world(world_size) else "gloo"
    if cards:
        torch.cuda.set_device(local_rank % cards)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def num_processes() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_pod_mesh(axis_names: tuple[str, ...] = ("dp", "tp"), tp: int | None = None) -> DeviceMesh:
    """Host-aware mesh: ``dp`` across hosts, ``tp`` within one.

    ``tp`` defaults to the ranks per host (``LOCAL_WORLD_SIZE``), which
    keeps every tensor-parallel collective inside a host; a smaller ``tp``
    must divide it. With one axis name, every rank goes on that axis.
    """
    _ensure_group()
    n = dist.get_world_size()
    if len(axis_names) == 1:
        return make_mesh(n, axis_names)
    local = _local_world(n)
    if tp is None:
        tp = local
    if local % tp != 0:
        raise ValueError(f"tp={tp} must divide the per-process device count {local} "
                         "so tensor-parallel collectives never cross hosts")
    return _build((n // tp, tp), axis_names)


def host_local_array(global_shape, mesh: DeviceMesh, dim: int, local_data, *,
                     axis: str | None = None) -> torch.Tensor:
    """This rank's block of a global array sharded along ``dim`` over the
    mesh axis ``axis`` (default: the mesh's first), checked against
    ``global_shape`` and placed on this rank's device (the default device,
    on the card the rank's own GPU): the entry path for
    data that each host reads for itself."""
    axis = axis or mesh.mesh_dim_names[0]
    _, w = axis_rank(mesh, axis)
    global_shape = tuple(global_shape)
    if global_shape[dim] % w:
        raise ValueError(f"global dimension {global_shape[dim]} does not divide the mesh "
                         f"axis {axis!r} of size {w}")
    want = global_shape[:dim] + (global_shape[dim] // w,) + global_shape[dim + 1:]
    local = torch.as_tensor(local_data)
    if tuple(local.shape) != want:
        raise ValueError(f"local block has shape {tuple(local.shape)}, expected {want} "
                         f"for global shape {global_shape}")
    dev = resolve_device()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return mark_shard(local.to(dev), mesh.get_group(axis))
