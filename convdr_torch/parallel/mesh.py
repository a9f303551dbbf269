"""Process groups, device meshes and batch sharding over ``torch.distributed``.

The counterpart of ``convdr_tpu/parallel/mesh.py``. The JAX package drives
every device of its mesh from one process; the port runs one process per
card (SPMD, launched by ``torchrun``), as the reference's NCCL embedding pass
does (reference gen_passage_embeddings.py:305-316). The mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` with the JAX axis names:

  * ``data``  -- batch sharding for encode and training (data parallel);
  * ``index`` -- passage-row sharding for retrieval.

Collectives run over ``mesh.get_group(axis)``: NCCL on the card, gloo on
the CPU when ``no_cuda`` asks for it. Nothing falls back from one to the
other. Every rank builds the same global batch; :func:`shard_batch` gives a
rank the contiguous slice that JAX's ``P(axis)`` placement gives its
device, and :func:`sharded_apply` is a jit with sharded inputs and a
replicated output: each rank computes its slice and the slices are
all-gathered in rank order. On one rank every axis has size 1 and the
collectives copy.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from convdr_torch.core.device import resolve_device

# how long a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(
    no_cuda: bool = False,
    *,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_rank: Optional[int] = None,
    init_method: str = "env://",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> torch.device:
    """Join the default process group; returns this rank's device.

    ``rank``, ``world_size`` and ``local_rank`` default to torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``. On the card the rank binds
    ``cuda:LOCAL_RANK`` before an NCCL group forms; ``no_cuda`` forms a gloo
    group on the CPU. A collective that waits longer than ``timeout`` raises.
    A group that exists already is kept.
    """
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = resolve_device(no_cuda)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo" if no_cuda else "nccl", init_method=init_method, timeout=timeout,
            world_size=world_size, rank=rank,
            device_id=None if no_cuda else device,
        )
    return device


@contextlib.contextmanager
def driver_mesh(axis_names: Sequence[str], *, no_mesh: bool, no_cuda: bool):
    """``(mesh, device)`` for a driver: under torchrun (``WORLD_SIZE`` in
    the environment) a mesh over every rank, all of them on the first axis,
    unless ``no_mesh``; otherwise ``(None, the one device)``. A group this
    opens is closed on exit."""
    if no_mesh or "WORLD_SIZE" not in os.environ:
        yield None, resolve_device(no_cuda)
        return
    opened = not dist.is_initialized()
    device = init_distributed(no_cuda)
    try:
        yield get_mesh(tuple(axis_names)), device
    finally:
        if opened:
            dist.destroy_process_group()


def get_mesh(
    axis_names: Sequence[str] = ("data",),
    axis_sizes: Optional[Sequence[int]] = None,
    devices: Optional[Sequence[int]] = None,
) -> DeviceMesh:
    """A mesh over the ranks of the default group (every rank calls it).

    With no explicit sizes, all ranks go to the first axis and remaining
    axes get size 1. ``devices`` orders the ranks (default: rank order).
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "get_mesh needs a process group: run under torchrun and call "
            "init_distributed() first"
        )
    devs = list(range(dist.get_world_size()) if devices is None else devices)
    if axis_sizes is None:
        axis_sizes = [len(devs)] + [1] * (len(axis_names) - 1)
    total = int(np.prod(axis_sizes))
    if total != dist.get_world_size() or sorted(devs) != list(range(total)):
        raise ValueError(
            f"Mesh wants {total} devices ({dict(zip(axis_names, axis_sizes))}) "
            f"but {len(devs)} are available"
        )
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if devices is None:
        return init_device_mesh(device_type, tuple(axis_sizes),
                                mesh_dim_names=tuple(axis_names))
    return DeviceMesh(device_type, torch.tensor(devs).reshape(tuple(axis_sizes)),
                      mesh_dim_names=tuple(axis_names))


def check_mesh(mesh) -> DeviceMesh:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed DeviceMesh (get_mesh), not {type(mesh).__name__}"
        )
    return mesh


def _dim(mesh: DeviceMesh, axis: str) -> int:
    names = check_mesh(mesh).mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has axes {names}, not {axis!r}")
    return names.index(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """``mesh.shape[axis]`` of the JAX mesh."""
    return mesh.size(_dim(mesh, axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's position along ``axis`` (JAX's ``lax.axis_index``)."""
    return mesh.get_local_rank(_dim(mesh, axis))


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(_dim(mesh, axis))


def mesh_shard(mesh: Optional[DeviceMesh], axis: str) -> Tuple[int, int]:
    """``(n_shards, shard)``: the size of ``axis`` and this rank's place on
    it; ``(1, 0)`` without a mesh."""
    if mesh is None:
        return 1, 0
    return axis_size(check_mesh(mesh), axis), axis_index(mesh, axis)


def is_main_rank(mesh: Optional[DeviceMesh] = None) -> bool:
    """Whether this process writes files: always without a mesh, on global
    rank 0 under one."""
    return mesh is None or dist.get_rank() == 0


def barrier(mesh: Optional[DeviceMesh] = None) -> None:
    """Wait for every rank (a no-op without a mesh), e.g. before reading
    what the main rank wrote."""
    if mesh is not None:
        dist.barrier()


def shard_rows(n: int, n_shards: int, shard: int, quantum: int = 1):
    """The contiguous row range ``[lo, hi)`` of ``shard`` when ``n`` rows
    are split into ``n_shards`` shards of ``rows`` rows each (``ceil(n /
    n_shards)`` rounded up to ``quantum``; the last shards may hold fewer
    rows or none). Returns ``(lo, hi, rows)``."""
    rows = pad_to_multiple(-(-n // n_shards), quantum)
    lo = min(n, shard * rows)
    return lo, min(n, lo + rows), rows


def batch_rows(mesh: Optional[DeviceMesh], n: int, axis: str = "data") -> slice:
    """This rank's contiguous rows of a global batch of ``n`` (all of them
    without a mesh), as JAX's ``P(axis)`` places them on this rank's
    device. ``n`` must divide by the axis size."""
    n_shards, shard = mesh_shard(mesh, axis)
    if n % n_shards:
        raise ValueError(f"leading dim {n} does not divide over {n_shards} {axis!r} shards")
    rows = n // n_shards
    return slice(shard * rows, (shard + 1) * rows)


def shard_batch(mesh: DeviceMesh, x, axis: str = "data"):
    """This rank's contiguous slice (:func:`batch_rows`) of the leading dim
    of a tensor, or of every tensor of a dict."""
    check_mesh(mesh)

    def one(a: torch.Tensor) -> torch.Tensor:
        return a[batch_rows(mesh, a.shape[0], axis)]

    return {k: one(v) for k, v in x.items()} if isinstance(x, dict) else one(x)


def replicate(mesh: DeviceMesh, x):
    """Broadcast the main rank's tensors (a tensor, a dict of them, or a
    module's parameters and buffers) to every rank, in place; returns x."""
    check_mesh(mesh)
    if isinstance(x, nn.Module):
        tensors = list(x.state_dict().values())
    elif isinstance(x, dict):
        tensors = list(x.values())
    else:
        tensors = [x]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    return x


def axis_max(mesh: DeviceMesh, axis: str, value: int, device: torch.device) -> int:
    """The largest of every ``axis`` rank's ``value``."""
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=axis_group(mesh, axis))
    return int(t.item())


def all_gather_rows(mesh: DeviceMesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``[S, *x.shape]``: every rank's ``x`` along ``axis``, in rank order
    (the list form of ``all_gather``, which every supported PyTorch has)."""
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x.contiguous(), group=axis_group(mesh, axis))
    return torch.stack(parts)


def sharded_apply(mesh: DeviceMesh, axis: str, fn: Callable, *inputs: torch.Tensor):
    """``fn(*inputs)`` computed data-parallel: the inputs' leading dim is
    padded to a multiple of the axis size with copies of its last row
    (``run_convdr_inference``'s query padding), each rank applies ``fn`` to
    its slice, and the outputs are gathered in rank order and cut back to
    the inputs' rows. Every rank must pass the same inputs."""
    n = inputs[0].shape[0]
    n_shards = axis_size(mesh, axis)
    pad = pad_to_multiple(n, n_shards) - n
    if pad:
        inputs = tuple(torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]) for a in inputs)
    out = fn(*(shard_batch(mesh, a, axis) for a in inputs))
    gathered = all_gather_rows(mesh, axis, out)
    return gathered.reshape(-1, *out.shape[1:])[:n]


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m
