"""Process groups, collectives and per-rank batches over ``torch.distributed``.

Port of `mink_octtree_stablediffusion_tpu/parallel/mesh.py`.  JAX runs one
program over a device mesh; here each rank is a process with its own copy
of the parameters and its own batch, and the ranks meet in collectives of a
process group:

- ``initialize_distributed`` joins the ranks (``tcp://`` with an address,
  else torchrun's environment), the counterpart of
  ``jax.distributed.initialize``;
- ``data_parallel_mesh`` gives the 1-D data group;
- ``shard_batch`` gives each rank its row of the stacked per-device batch
  (``data.collate.stack_devices``), and ``shard_batch_pytree`` the same
  for every array of a nested batch on a mesh's data axis (JAX's
  ``shard_batch_pytree``); ``batch_sharding`` and ``replicate`` name the
  placements (``Shard(0)`` on the data axis, ``Replicate()``), as JAX's
  ``NamedSharding``s do;
- ``all_reduce_sum`` is a differentiable sum across the group (JAX's
  ``psum``, whose transpose is a ``psum``), for SyncBN;
- ``gather_to_host`` gives every rank's tensor, through the host.

The backend is the caller's explicit choice: NCCL when each rank has its
own GPU; gloo when ranks share one GPU (NCCL refuses two ranks on one
device; gloo's ``all_reduce`` and ``broadcast`` take CUDA tensors through
the host) or run on the CPU.  ``check_backend`` refuses a choice that
cannot work rather than switching.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from ..data.collate import device_row

BACKENDS = ("nccl", "gloo")


def check_backend(backend: str, device, nproc: Optional[int] = None) -> None:
    """Raise unless ``backend`` can serve ``nproc`` ranks on ``device``:
    NCCL needs CUDA and a GPU of its own for each rank on this host."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("NCCL needs CUDA tensors; use gloo on the CPU")
    if nproc is not None and nproc > torch.cuda.device_count():
        raise ValueError(
            f"NCCL needs one GPU per rank ({nproc} ranks, "
            f"{torch.cuda.device_count()} GPUs); ranks that share a GPU "
            "take gloo")


def free_port() -> int:
    """A free TCP port on the loopback interface (for ``tcp://`` init)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device, local_rank: int, local_ranks: int = 1
                ) -> torch.device:
    """The device of this host's rank ``local_rank``: GPU ``local_rank mod
    count``, made the current one, or the CPU, with the host's cores
    shared among its ``local_ranks`` ranks."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_ranks))
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu'")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: str,
                           timeout: Optional[timedelta] = None) -> None:
    """Join the process group: ``coordinator_address`` ``host:port`` with
    ``num_processes`` and this rank's ``process_id`` (``tcp://`` init), or,
    without an address, torchrun's ``MASTER_ADDR``/``MASTER_PORT``/
    ``WORLD_SIZE``/``RANK`` (``env://``).  ``timeout`` bounds the
    rendezvous and every collective (default: PyTorch's)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    kw = {} if timeout is None else {"timeout": timeout}
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, **kw)


def data_parallel_mesh(num_devices: Optional[int] = None):
    """The 1-D data group over ranks ``0..num_devices-1`` (default: all).

    A process group, not a ``DeviceMesh``: the data-parallel step and
    SyncBN need only collectives, which take a group, and a group of
    ranks that share one card needs no device layout.  Every rank must
    call this (``new_group`` is collective)."""
    world = dist.get_world_size()
    if num_devices is None or num_devices == world:
        return dist.group.WORLD
    if num_devices > world:
        raise ValueError(f"need {num_devices} ranks, have {world}")
    return dist.new_group(list(range(num_devices)))


def shard_batch(stacked: Sequence[np.ndarray], group=None,
                device=None) -> tuple:
    """This rank's row of a batch stacked on a leading device axis
    (``data.collate.stack_devices``), as tensors on ``device``."""
    world = dist.get_world_size(group)
    if len(stacked[0]) != world:
        raise ValueError(f"{len(stacked[0])} device rows for {world} ranks")
    return tuple(torch.as_tensor(np.ascontiguousarray(x), device=device)
                 for x in device_row(stacked, dist.get_rank(group)))


def _mesh_axes(mesh, axis_name: str):
    """(the axis names, ``axis_name``'s group) of a ``DeviceMesh``, or of
    a process group (None: all ranks) taken as a 1-D mesh on
    ``axis_name``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return (axis_name,), mesh
    return tuple(names), mesh.get_group(axis_name)


def batch_sharding(mesh, axis_name: str = "data") -> tuple:
    """The placements of a batch on ``mesh``: rows (the leading axis)
    sharded on ``axis_name`` (``Shard(0)``), replicated on every other
    axis; one placement a mesh axis."""
    names, _ = _mesh_axes(mesh, axis_name)
    return tuple(Shard(0) if n == axis_name else Replicate() for n in names)


def replicate(mesh) -> tuple:
    """The placements of a tensor every rank holds whole (parameters,
    schedulers): ``Replicate()`` on every axis of ``mesh``."""
    names, _ = _mesh_axes(mesh, "data")
    return (Replicate(),) * len(names)


def shard_batch_pytree(batch, mesh, axis_name: str = "data", device=None):
    """This rank's block of every array of a nested batch (tuples, lists
    and dicts of arrays) stacked on a leading axis of one entry a rank of
    ``mesh``'s ``axis_name`` (``data.collate.stack_devices``), as tensors
    on ``device``: ``shard_batch`` on each array.  Ranks on the other axes
    get the same block."""
    _, group = _mesh_axes(mesh, axis_name)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(put(v) for v in x)
        return shard_batch((x,), group, device)[0]
    return put(batch)


class _AllReduceSum(torch.autograd.Function):
    """Sum across the group; its backward sums the cotangents across the
    group (the transpose of a sum that every rank receives)."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable ``psum``: every rank gets the same sum, bit for bit."""
    return _AllReduceSum.apply(tensor, group if group is not None
                               else dist.group.WORLD)


def gather_to_host(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (the same shape and dtype on each), as CPU
    tensors in rank order: gloo gathers only CPU tensors."""
    t = t.detach().cpu()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts
