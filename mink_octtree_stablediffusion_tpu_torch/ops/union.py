"""Coordinate-set union with feature accumulation.

Port of `mink_octtree_stablediffusion_tpu/ops/union.py::union`: the rows
of every input are deduplicated into one canonical buffer
(`unique_coords`) and the features of coinciding coordinates add.

- With an unbounded input, the union is unbounded, in (batch, Morton)
  order: row for row the JAX package's.
- With every input bounded, the union is bounded by the inputs' largest
  extent and in the port's row-major flat-key order, the canonical order
  of bounded grids that the sorted search and the fused conv rely on.
  The JAX package sorts this case in Morton order too and still stamps
  the extent (`ROADMAP.md` §C, departure 3); the set of rows is the same.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .coords import INVALID_COORD, SparseGrid, unique_coords


def union(grids: Sequence[SparseGrid], features: Sequence[torch.Tensor],
          capacity: Optional[int] = None):
    """Union of N sparse tensors → ``(grid, features)``; features at the
    same coordinate add.  All inputs share stride and batch size; the
    capacity is ``capacity`` or the largest input's."""
    g0 = grids[0]
    if any(g.stride != g0.stride or g.batch_size != g0.batch_size
           for g in grids):
        raise ValueError("union needs one stride and batch size")
    cap = capacity or max(g.capacity for g in grids)
    extent = None
    if all(g.extent is not None for g in grids):
        extent = tuple(max(g.extent[i] for g in grids)
                       for i in range(g0.ndim))
    valid = torch.cat([g.valid for g in grids])
    coords = torch.cat([g.coords for g in grids]).masked_fill(
        ~valid[:, None], INVALID_COORD)
    uc, uv, inverse, _ = unique_coords(coords, valid, cap, g0.stride,
                                       extent=extent,
                                       batch_size=g0.batch_size)
    feats = torch.cat([f * g.valid[:, None].to(f.dtype)
                       for f, g in zip(features, grids)])
    acc = feats.new_zeros((cap + 1, feats.shape[1])).index_add_(
        0, inverse.long(), feats)
    grid = SparseGrid(coords=uc, valid=uv, stride=g0.stride,
                      batch_size=g0.batch_size, extent=extent)
    return grid, acc[:cap]
