"""Trilinear interpolation and splatting between continuous points and
voxels.

Port of `mink_octtree_stablediffusion_tpu/ops/interp.py`: each continuous
query point reads from (``interpolate``) or writes to (``splat``) its 2^D
surrounding lattice corners with multilinear weights; the corner rows are
found with ``grid_lookup``, as a kernel map's.  ``splat_coordinates``
makes the (unbounded) grid of all corners.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .conv import gather_rows
from .coords import INVALID_COORD, SparseGrid, unique_coords
from .kernels import _tuplize
from .neighbors import grid_lookup


def _corners(ndim: int) -> np.ndarray:
    return np.array(list(itertools.product([0, 1], repeat=ndim)),
                    dtype=np.float32)


def interpolation_weights(points: torch.Tensor, stride):
    """For continuous batched points [M, 1+D] (float): the corners'
    integer coordinates [2^D, M, 1+D] and multilinear weights [2^D, M]."""
    d = points.shape[1] - 1
    s = torch.as_tensor(np.asarray(stride, np.float32).reshape(1, -1),
                        device=points.device)
    xyz = points[:, 1:] / s
    base = torch.floor(xyz)
    frac = xyz - base
    batch = points[:, :1].to(torch.int32)
    coords, weights = [], []
    for c in _corners(d):
        cj = torch.as_tensor(c[None, :], device=points.device)
        corner = ((base + cj) * s).to(torch.int32)
        weights.append(torch.where(cj > 0, frac, 1.0 - frac).prod(dim=-1))
        coords.append(torch.cat([batch, corner], dim=-1))
    return torch.stack(coords), torch.stack(weights)


def interpolate(grid: SparseGrid, features: torch.Tensor,
                points: torch.Tensor, points_valid: torch.Tensor
                ) -> torch.Tensor:
    """Voxel features sampled at continuous points → [M, C]: the weighted
    sum over the corners, a missing corner contributing zero."""
    corner_coords, w = interpolation_weights(points, grid.stride)
    k, m, nf = corner_coords.shape
    idx = grid_lookup(grid, corner_coords.reshape(k * m, nf),
                      points_valid.repeat(k)).reshape(k, m)
    out = 0.0
    for kk in range(k):
        out = out + gather_rows(features, idx[kk]) * w[kk][:, None]
    return out * points_valid[:, None].to(features.dtype)


def splat_coordinates(points: torch.Tensor, points_valid: torch.Tensor,
                      stride, capacity: int, batch_size: int) -> SparseGrid:
    """The unique lattice corners of all points, an unbounded grid."""
    corner_coords, _ = interpolation_weights(points, stride)
    k, m, nf = corner_coords.shape
    fv = points_valid.repeat(k)
    flat = corner_coords.reshape(k * m, nf).masked_fill(~fv[:, None],
                                                        INVALID_COORD)
    uc, uv, _, _ = unique_coords(flat, fv, capacity, stride)
    return SparseGrid(coords=uc, valid=uv, stride=_tuplize(stride, nf - 1),
                      batch_size=batch_size)


def splat(grid: SparseGrid, points: torch.Tensor,
          points_valid: torch.Tensor, point_features: torch.Tensor
          ) -> torch.Tensor:
    """Point features scattered onto the grid's rows with multilinear
    weights → [N, C]."""
    corner_coords, w = interpolation_weights(points, grid.stride)
    k, m, nf = corner_coords.shape
    n = grid.capacity
    idx = grid_lookup(grid, corner_coords.reshape(k * m, nf),
                      points_valid.repeat(k)).reshape(k, m)
    acc = point_features.new_zeros((n + 1, point_features.shape[1]))
    pf = point_features * points_valid[:, None].to(point_features.dtype)
    for kk in range(k):
        dest = torch.where(idx[kk] >= 0, idx[kk], n).long()
        acc.index_add_(0, dest, pf * w[kk][:, None])
    return acc[:n]
