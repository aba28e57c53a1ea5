"""Kernel maps: padded gather-index tensors connecting two SparseGrids.

Port of `mink_octtree_stablediffusion_tpu/ops/neighbors.py`: the map is a
dense ``int32[K, N_out]`` gather-index array with -1 sentinels — every
output row looks up its input neighbour for every kernel offset.
"""

from __future__ import annotations

import torch

from . import lut as _lut
from .coords import UNBOUNDED_MSG, SparseGrid, device_const
from .kernels import KernelSpec
from .search import lookup_sorted


def grid_lookup(grid: SparseGrid, queries: torch.Tensor,
                queries_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Coordinate → row query: a dense LUT when the grid's key space fits
    ``LUT_MAX_ENTRIES``, else the sorted flat-key search."""
    if grid.extent is None:
        raise NotImplementedError(UNBOUNDED_MSG)
    if _lut.lut_entries(grid.extent, grid.stride,
                        grid.batch_size) <= _lut.LUT_MAX_ENTRIES:
        table = _lut.build_lut(grid.coords, grid.valid, grid.stride,
                               grid.extent, grid.batch_size)
        return _lut.lut_lookup(table, grid.stride, grid.extent,
                               grid.batch_size, queries, queries_valid)
    return lookup_sorted(grid.coords, grid.valid, grid.stride, queries,
                         queries_valid, extent=grid.extent,
                         grid_keys=grid.flat_keys())


def kernel_map(in_grid: SparseGrid, out_grid: SparseGrid,
               spec: KernelSpec) -> torch.Tensor:
    """Gather indices ``idx[K, N_out]``: input row for each (offset, out row).

    conv: in_coord = out_coord + delta; transpose: query in at
    out_coord − delta."""
    offs = spec.absolute_offsets(in_grid.stride)
    sign = -1 if spec.transpose else 1
    k = offs.shape[0]
    n_out = out_grid.capacity
    deltas = device_const(sign * offs, torch.int32, out_grid.device)
    q_xyz = out_grid.coords[None, :, 1:] + deltas[:, None, :]  # [K, N, D]
    q_b = out_grid.coords[None, :, :1].expand(k, n_out, 1)
    queries = torch.cat([q_b, q_xyz], dim=-1).reshape(k * n_out, -1)
    q_valid = out_grid.valid[None, :].expand(k, n_out).reshape(-1)
    return grid_lookup(in_grid, queries, q_valid).reshape(k, n_out)


def membership(query_grid: SparseGrid, target_grid: SparseGrid
               ) -> torch.Tensor:
    """bool[N_query]: is each (valid) query coordinate present in target?"""
    idx = grid_lookup(target_grid, query_grid.coords, query_grid.valid)
    return (idx >= 0) & query_grid.valid
