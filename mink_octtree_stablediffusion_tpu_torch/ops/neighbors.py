"""Kernel maps: padded gather-index tensors connecting two SparseGrids.

Port of `mink_octtree_stablediffusion_tpu/ops/neighbors.py`: the map is a
dense ``int32[K, N_out]`` gather-index array with -1 sentinels — every
output row looks up its input neighbour for every kernel offset.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lut as _lut
from .coords import SparseGrid, _flat_bound, device_const
from .hashtable import lookup as _hash_lookup
from .kernels import KernelSpec
from .search import lookup_sorted


def lookup_route(grid: SparseGrid, device: torch.device) -> str:
    """The route ``grid_lookup`` takes on ``device``, as the JAX package
    chooses it: the dense LUT for a bounded grid whose key space fits
    ``LUT_MAX_ENTRIES``; the hash table for an unbounded grid on an
    accelerator (here: CUDA tensors); else the sorted search."""
    if grid.extent is not None and _lut.lut_entries(
            grid.extent, grid.stride, grid.batch_size) <= _lut.LUT_MAX_ENTRIES:
        return "lut"
    if grid.extent is None and device.type == "cuda":
        return "hash"
    return "sorted"


def grid_lookup(grid: SparseGrid, queries: torch.Tensor,
                queries_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Coordinate → row query (-1 where absent) by ``lookup_route``'s
    route.  Every route gives the same rows, except where the sorted
    search's duplicate window misses (`ops.search`)."""
    route = lookup_route(grid, queries.device)
    if route == "lut":
        table = _lut.build_lut(grid.coords, grid.valid, grid.stride,
                               grid.extent, grid.batch_size)
        return _lut.lut_lookup(table, grid.stride, grid.extent,
                               grid.batch_size, queries, queries_valid)
    if route == "hash":
        return _hash_lookup(grid.hash_table(), queries, queries_valid)
    keys = (grid.flat_keys() if _flat_bound(grid.extent, grid.stride,
                                            grid.ndim) is not None else None)
    return lookup_sorted(grid.coords, grid.valid, grid.stride, queries,
                         queries_valid, extent=grid.extent, grid_keys=keys)


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


def identity_map(in_grid: SparseGrid, out_grid: SparseGrid) -> torch.Tensor:
    """Row map out → in for grids over the same coordinate set."""
    return grid_lookup(in_grid, out_grid.coords, out_grid.valid)


def get_coords_map(fine_grid: SparseGrid, coarse_grid: SparseGrid
                   ) -> torch.Tensor:
    """int32[N_fine]: the coarse row of the voxel holding each fine
    coordinate (-1 if absent).  The coarse stride must be a multiple of the
    fine stride."""
    cs = np.asarray(coarse_grid.stride, np.int32)
    if np.any(cs % np.asarray(fine_grid.stride, np.int32)):
        raise ValueError("coarse stride must divide by fine stride")
    csj = device_const(cs, torch.int32, fine_grid.device)
    down = torch.cat([fine_grid.coords[:, :1],
                      torch.div(fine_grid.coords[:, 1:], csj,
                                rounding_mode="floor") * csj], dim=-1)
    return grid_lookup(coarse_grid, down, fine_grid.valid)
