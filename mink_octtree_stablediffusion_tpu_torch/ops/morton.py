"""Morton (Z-order) codes for batched integer voxel coordinates.

Port of `mink_octtree_stablediffusion_tpu/ops/morton.py`: the bits of the
stride-normalised spatial coordinates are interleaved into one
non-negative int32 key, dimension 0 in the most significant interleaved
position.  The port's bounded grids are ordered by the row-major flat key
(`ops.coords.flat_cell_key`); the Morton order is imposed locally where a
module needs it (`nn.attention.MortonWindowTransformer`).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import _tuplize


def bits_per_dim(ndim: int) -> int:
    """Bits of each spatial coordinate in the key (30 bits in all, so the
    key is a non-negative int32)."""
    return 30 // ndim


def morton_encode(xyz: torch.Tensor, stride=1) -> torch.Tensor:
    """int32 Morton codes of the spatial coordinates ``xyz`` [N, D]: each
    coordinate is floor-divided by ``stride`` (an int or one per
    dimension), offset by ``half`` into the non-negative range and clipped
    to ``bits_per_dim`` bits, so distant out-of-range coordinates may share
    a code."""
    n, d = xyz.shape
    bits = bits_per_dim(d)
    half = 1 << (bits - 1)
    from .coords import device_const  # coords imports this module

    s = device_const(_tuplize(stride, d), torch.int32, xyz.device)
    q = torch.div(xyz.to(torch.int32), s, rounding_mode="floor") + half
    q = q.clamp(0, (1 << bits) - 1)
    code = torch.zeros((n,), dtype=torch.int32, device=xyz.device)
    for bit in range(bits):
        for dim in range(d):
            src = (q[:, dim] >> bit) & 1
            code = code | (src << (bit * d + (d - 1 - dim)))
    return code


def morton_decode(code: torch.Tensor, ndim: int) -> torch.Tensor:
    """Inverse of :func:`morton_encode` at stride 1: [N, ndim] int32
    coordinates with the offset removed."""
    bits = bits_per_dim(ndim)
    half = 1 << (bits - 1)
    code = code.to(torch.int32)
    out = []
    for dim in range(ndim):
        v = torch.zeros_like(code)
        for bit in range(bits):
            v = v | (((code >> (bit * ndim + (ndim - 1 - dim))) & 1) << bit)
        out.append(v - half)
    return torch.stack(out, dim=-1)


def morton_encode_np(xyz: np.ndarray, stride=1) -> np.ndarray:
    """NumPy twin of :func:`morton_encode` for host-side pipelines."""
    n, d = xyz.shape
    bits = bits_per_dim(d)
    half = 1 << (bits - 1)
    q = np.floor_divide(xyz.astype(np.int64), stride) + half
    q = np.clip(q, 0, (1 << bits) - 1)
    code = np.zeros((n,), dtype=np.int64)
    for bit in range(bits):
        for dim in range(d):
            code |= ((q[:, dim] >> bit) & 1) << (bit * d + (d - 1 - dim))
    return code.astype(np.int32)
