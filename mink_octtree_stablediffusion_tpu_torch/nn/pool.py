"""Pooling and broadcast layers over sparse tensors.

Port of `LocalPool`, `PoolTranspose`, `global_pool_features`,
`GlobalPool`, `broadcast_op`, `broadcast_concat` and `GlobalMaxAvgPool`
from `mink_octtree_stablediffusion_tpu/nn/pool.py`: local pooling reduces
over the convolution's kernel maps (`ops.pool.local_pool_apply`), global
pooling and the broadcasts are masked reductions and gathers on the batch
column.  None has a parameter.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.coords import SparseGrid, stride_grid
from ..ops.kernels import KernelSpec, RegionType
from ..ops.neighbors import kernel_map
from ..ops.pool import broadcast_batch, global_pool, local_pool_apply
from ..tensor import SparseTensor


class LocalPool(nn.Module):
    """Sum/avg/max pooling over the kernel neighbourhood.  ``out_grid``
    pins the output coordinates; otherwise stride 1 keeps the input grid
    and a larger stride coarsens it into ``out_capacity`` rows (default:
    the input's capacity)."""

    def __init__(self, kernel_size=2, stride=2, dilation=1,
                 mode: str = "avg",
                 region_type: RegionType = RegionType.HYPER_CUBE,
                 out_capacity: Optional[int] = None, ndim: int = 3):
        super().__init__()
        self.spec = KernelSpec(kernel_size, stride, dilation, ndim=ndim,
                               region_type=region_type)
        self.mode = mode
        self.out_capacity = out_capacity

    def forward(self, x: SparseTensor, out_grid: Optional[SparseGrid] = None,
                out_capacity: Optional[int] = None) -> SparseTensor:
        spec = self.spec
        if out_grid is None:
            out_grid = (x.grid if all(s == 1 for s in spec.stride) else
                        stride_grid(x.grid, spec.stride,
                                    out_capacity or self.out_capacity or
                                    x.capacity))
        out, _ = local_pool_apply(x.features,
                                  kernel_map(x.grid, out_grid, spec),
                                  self.mode)
        return SparseTensor(grid=out_grid, features=out).mask_features()


class PoolTranspose(nn.Module):
    """Unpooling onto a known finer grid: each fine voxel pools its coarse
    kernel neighbours (average by default)."""

    def __init__(self, kernel_size=2, stride=2, dilation=1,
                 mode: str = "avg", ndim: int = 3):
        super().__init__()
        self.spec = KernelSpec(kernel_size, stride, dilation, ndim=ndim,
                               transpose=True)
        self.mode = mode

    def forward(self, x: SparseTensor, out_grid: SparseGrid) -> SparseTensor:
        out, _ = local_pool_apply(x.features,
                                  kernel_map(x.grid, out_grid, self.spec),
                                  self.mode)
        return SparseTensor(grid=out_grid, features=out).mask_features()


def global_pool_features(x: SparseTensor, mode: str = "avg") -> torch.Tensor:
    """Per-instance [B, C] reduction (sum, avg or max; an empty instance
    gives 0)."""
    out, _ = global_pool(x.features, x.grid.batch_ids(), x.batch_size,
                         x.valid, mode)
    return out


class GlobalPool(nn.Module):

    def __init__(self, mode: str = "avg"):
        super().__init__()
        self.mode = mode

    def forward(self, x: SparseTensor) -> torch.Tensor:
        return global_pool_features(x, self.mode)


def broadcast_op(x: SparseTensor, per_batch: torch.Tensor,
                 op: str = "add") -> SparseTensor:
    """Combine per-instance vectors [B, C] with every voxel row."""
    b = broadcast_batch(per_batch, x.grid.batch_ids(), x.valid)
    if op == "add":
        return x.with_features(x.features + b)
    if op == "mul":
        return x.with_features(x.features * b)
    if op == "copy":
        return x.with_features(b)
    raise ValueError(op)


def broadcast_concat(x: SparseTensor, per_batch: torch.Tensor
                     ) -> SparseTensor:
    """Each voxel row's features followed by its instance's vector."""
    b = broadcast_batch(per_batch, x.grid.batch_ids(), x.valid)
    return x.with_features(torch.cat([x.features, b], dim=-1))


class GlobalMaxAvgPool(nn.Module):
    """cat(global max, global avg) → [B, 2C], the classification head's
    pooling."""

    def forward(self, x: SparseTensor) -> torch.Tensor:
        return torch.cat([global_pool_features(x, "max"),
                          global_pool_features(x, "avg")], dim=-1)
