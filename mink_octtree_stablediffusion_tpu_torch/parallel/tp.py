"""Tensor parallelism over a 2-D ``(data, model)`` mesh.

Port of `mink_octtree_stablediffusion_tpu/parallel/tp.py`.  JAX commits
the parameters to a ``NamedSharding`` and lets XLA insert the collectives;
here each rank is a process that keeps only its slice of each sharded
parameter and runs the collectives itself (Megatron's column-parallel
layer):

- ``param_spec`` is the placement rule: a ``(K, Cin, Cout)`` conv kernel
  with K > 1 is sharded on Cout (``Shard(2)``), a 2-D dense kernel in
  flax's ``(in, out)`` layout on ``out`` (``Shard(1)``), anything else,
  or a dimension that does not split into parts of at least ``min_dim``,
  is replicated.  It takes the flax shape: the port's ``Dense`` keeps
  ``weight [out, in]``, so ``param_shardings`` passes it transposed and
  reports its ``out`` axis as ``Shard(0)``.
- ``dp_tp_mesh`` builds the mesh, ``shard_model_params`` replaces each
  sharded parameter by this model rank's slice (a plain ``nn.Parameter``
  tagged with its ``ModelShard``), ``gather_model_params`` gives the whole
  parameters back on every rank.
- A sharded conv (``nn.conv``'s three layers) or ``Dense`` computes its
  Cout slice from ``copy_to_model(x)`` (identity forward, the sum of the
  ranks' partial dF backward) and ``gather_from_model`` concatenates the
  slices (backward: this rank's slice of the cotangent, since every model
  rank computes the same thing downstream); the bias is added after the
  gather.  Any other sharded parameter (``ChannelwiseConv``'s ``[K, C]``,
  a codebook, a table) keeps its slice and is gathered whole at each use
  through a ``torch.nn.utils.parametrize`` parametrization.

The parameters are not ``DTensor``s: ranks that share one card run gloo,
which takes CUDA tensors only in ``all_reduce`` and ``broadcast``, and a
``DTensor`` redistribution needs ``all_gather_into_tensor``,
``reduce_scatter_tensor`` or ``scatter``.  So the gather is an
``all_reduce`` of this rank's slice written into a zero buffer of the
full width: exact (every other element adds zeros), at ``n_model`` times
the bytes of a true all-gather, on both devices alike.  ``COMM`` counts
each kind of model-axis collective's calls, bytes and host seconds.

Optimizers that act element by element (SGD, Adam, AdamW) step a slice
as they would the whole; where ``train.optim`` reduces over a whole
parameter (the global-norm clip, Adafactor's factored row and column
means) it sums the slices' parts over the model group
(``sum_over_model``).
"""

from __future__ import annotations

import re
import time
from typing import Dict, NamedTuple, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard
from torch.nn.utils import parametrize

# model-axis collectives by kind: the activation gathers, the dF sums of
# the input copies, the gathers of a whole weight, and the optimizer's sums
# over a whole parameter (the clip's norm, Adafactor's factored means)
COMM: Dict[str, Dict[str, float]] = {}
COMM_KINDS = ("gather", "dF_sum", "weight_gather", "optim_sum")


def reset_comm() -> None:
    """Set every kind's ``calls``, ``bytes`` and ``seconds`` to 0."""
    for kind in COMM_KINDS:
        COMM[kind] = {"calls": 0, "bytes": 0, "seconds": 0.0}


reset_comm()


class ModelShard(NamedTuple):
    """Where a local parameter slice lies: ``rank`` of ``size`` equal
    parts of dimension ``dim`` (of the port's own layout), the model
    ``group`` holding the others."""
    group: object
    rank: int
    size: int
    dim: int


def param_spec(shape: Sequence[int], n_model: int, min_dim: int = 2):
    """The placement of one parameter of flax ``shape`` on a model axis
    of ``n_model`` ranks."""
    shape = tuple(shape)
    if (len(shape) == 3 and shape[0] > 1 and shape[2] % n_model == 0 and
            shape[2] // n_model >= min_dim):
        return Shard(2)
    if (len(shape) == 2 and shape[1] % n_model == 0 and
            shape[1] // n_model >= min_dim):
        return Shard(1)
    return Replicate()


def dp_tp_mesh(n_data: int, n_model: int, device_type: str = "cuda"):
    """The 2-D ``DeviceMesh`` named ``("data", "model")`` over all ranks,
    adjacent ranks on the model axis (JAX's ``devices.reshape(n_data,
    n_model)``): with 2 × 2, model groups {0, 1} and {2, 3}, data groups
    {0, 2} and {1, 3}.  Every rank calls it (the groups are formed
    collectively); the process group must have ``n_data · n_model``
    ranks.  Ranks that share one card pass ``"cuda"`` with gloo: the mesh
    only names the groups, and each rank has set its device before."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} ranks, have {world}")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def _model_axis(mesh):
    return (mesh.get_group("model"), mesh.get_local_rank("model"),
            mesh["model"].size())


def _all_reduce(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place, counted under ``kind``.  The
    seconds start where the device has finished the queued work (gloo
    copies a CUDA tensor to the host, which waits for it anyway), so they
    hold the collective alone."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    rec = COMM[kind]
    rec["calls"] += 1
    rec["bytes"] += t.numel() * t.element_size()
    rec["seconds"] += time.perf_counter() - t0
    return t


def _gather(local: torch.Tensor, shard: ModelShard, kind: str, dim: int
            ) -> torch.Tensor:
    """The ranks' slices of dimension ``dim`` concatenated: this rank's
    slice in a zero buffer of the full width, summed over the group."""
    d = dim % local.dim()
    moved = local.movedim(d, -1)
    c = moved.shape[-1]
    full = moved.new_zeros(moved.shape[:-1] + (c * shard.size,))
    full[..., shard.rank * c:(shard.rank + 1) * c] = moved
    return _all_reduce(full, shard.group, kind).movedim(-1, d)


def _local(full: torch.Tensor, shard: ModelShard, dim: int) -> torch.Tensor:
    """This rank's slice of ``full`` along ``dim``."""
    return full.chunk(shard.size, dim)[shard.rank]


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity; its backward sums the model ranks'
    partial cotangents (each rank's slice of the output gives a partial
    dF)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return _all_reduce(g, ctx.shard.group, "dF_sum"), None


class _GatherFromModel(torch.autograd.Function):
    """Megatron's g: the ranks' slices of dimension ``dim`` concatenated;
    its backward is this rank's slice of the cotangent (not a sum:
    downstream of the gather every model rank computes the same
    thing)."""

    @staticmethod
    def forward(ctx, y, shard, kind, dim):
        ctx.shard, ctx.dim = shard, dim
        return _gather(y, shard, kind, dim)

    @staticmethod
    def backward(ctx, g):
        return (_local(g, ctx.shard, ctx.dim).contiguous(), None, None,
                None)


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    return _CopyToModel.apply(x, shard)


def gather_from_model(y: torch.Tensor, shard: ModelShard,
                      kind: str = "gather", dim: int = -1) -> torch.Tensor:
    """The model ranks' slices of ``y`` along ``dim`` (by default the
    channels of an activation) concatenated."""
    return _GatherFromModel.apply(y, shard, kind, dim)


class _GatheredWeight(nn.Module):
    """The parametrization of a sharded parameter outside the
    column-parallel layers: it stores this rank's slice
    (``right_inverse``) and gives the whole tensor at each use."""

    def __init__(self, shard: ModelShard):
        super().__init__()
        self.shard = shard

    def forward(self, local):
        return gather_from_model(local, self.shard, "weight_gather",
                                 self.shard.dim)

    def right_inverse(self, full):
        return _local(full, self.shard, self.shard.dim).clone()


def _port_spec(module: nn.Module, name: str, p: torch.Tensor,
               n_model: int, min_dim: int):
    """``param_spec`` of a parameter, in the port's own layout.  The rule
    takes flax's shape: a ``torch.nn.Linear`` weight ``[out, in]`` is
    flax's ``[in, out]`` (its ``Shard(1)`` is the port's ``Shard(0)``);
    the port keeps every other parameter the rule can shard in flax's
    layout (conv kernels ``[K, Cin, Cout]``, 2-D kernels, tables)."""
    if isinstance(module, nn.Linear) and name == "weight":
        spec = param_spec(tuple(p.shape)[::-1], n_model, min_dim)
        return spec if isinstance(spec, Replicate) else Shard(1 - spec.dim)
    return param_spec(p.shape, n_model, min_dim)


def _leaves(module: nn.Module):
    """(name, owner, leaf name, parameter, its shard or None) of every
    parameter, by its name in the unsharded module."""
    for mname, sub in module.named_modules():
        if "parametrizations" in mname.split("."):
            continue  # a parametrization's own modules: listed by owner
        params = dict(sub.named_parameters(recurse=False))
        if parametrize.is_parametrized(sub):
            for pname, plist in sub.parametrizations.items():
                params[pname] = plist.original
        for pname, p in params.items():
            name = f"{mname}.{pname}" if mname else pname
            yield name, sub, pname, p, getattr(p, "model_shard", None)


def param_shardings(module: nn.Module, mesh, min_dim: int = 2) -> dict:
    """``{parameter name: (data placement, model placement)}`` in the
    port's layout, every parameter replicated on the data axis; a
    parameter already sharded keeps its placement."""
    _, _, n_model = _model_axis(mesh)
    out = {}
    for name, sub, pname, p, shard in _leaves(module):
        out[name] = (Replicate(), Shard(shard.dim) if shard is not None
                     else _port_spec(sub, pname, p, n_model, min_dim))
    return out


@torch.no_grad()
def shard_model_params(module: nn.Module, mesh, min_dim: int = 2
                       ) -> nn.Module:
    """Replace, in place, every parameter that ``param_spec`` shards by
    this model rank's slice, and return ``module``.  Every rank must hold
    the same whole parameters before (a seeded build, or
    ``train.broadcast_module``), and build the optimizer after.  A
    column-parallel layer (a module whose ``tp_weight`` names the
    parameter: the sparse convs' ``kernel``, ``Dense``'s ``weight``)
    keeps the slice as its parameter and gets ``model_shard``; any other
    module gets a parametrization that gathers the whole tensor at use.
    A parameter already sharded is left as it is."""
    group, rank, n_model = _model_axis(mesh)
    for _, sub, pname, p, shard in list(_leaves(module)):
        if shard is not None:
            continue
        spec = _port_spec(sub, pname, p, n_model, min_dim)
        if isinstance(spec, Replicate):
            continue
        shard = ModelShard(group, rank, n_model, spec.dim)
        if getattr(sub, "tp_weight", None) == pname:
            local = nn.Parameter(_local(p, shard, shard.dim).clone(),
                                 requires_grad=p.requires_grad)
            setattr(sub, pname, local)
            sub.model_shard = shard
        else:
            parametrize.register_parametrization(
                sub, pname, _GatheredWeight(shard), unsafe=True)
            local = sub.parametrizations[pname].original
        local.model_shard = shard
    return module


_PARAMETRIZED = re.compile(r"parametrizations\.(\w+)\.original$")


@torch.no_grad()
def gather_model_params(module: nn.Module, mesh, grads: bool = False,
                        device=None) -> Dict[str, torch.Tensor]:
    """``{name: the whole parameter}`` on every rank, by the names of the
    unsharded module (the counterpart of reading a global JAX array):
    each sharded slice is gathered over ``mesh``'s model axis, each
    replicated parameter copied.  ``grads``: the same of the parameters'
    gradients, where they have one.  ``device``: where each whole tensor
    goes as soon as it is gathered (default: where its slice is)."""
    group, rank, n_model = _model_axis(mesh)
    out = {}
    for name, p in module.named_parameters():
        t = p.grad if grads else p
        if t is None:
            continue
        shard = getattr(p, "model_shard", None)
        name = _PARAMETRIZED.sub(r"\1", name)
        out[name] = (t.detach().clone() if shard is None else _gather(
            t.detach(), shard._replace(group=group, rank=rank,
                                       size=n_model), "weight_gather",
            shard.dim)).to(device or t.device)
    return out


def sum_over_model(t: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """A sum over this rank's slice (of squares, for a norm or a second
    moment) summed over the model group: the whole parameter's sum."""
    return _all_reduce(t.contiguous(), shard.group, "optim_sum")
