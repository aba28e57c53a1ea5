"""8³-brick addressing between grid rows and dense bricks.

Port of `mink_octtree_stablediffusion_tpu/ops/brick.py` (the layout, the
row ↔ brick scatter and gather, and the 27-slab ``brick_conv_xla``).
Bounded 3-D grids only:

  slot(b, x, y, z) = ((b·Bx + x/8)·By + y/8)·Bz + z/8     (dense brick space)
  within(x, y, z)  = ((x%8)·8 + y%8)·8 + z%8              (voxel in brick)

with ``(x, y, z)`` the stride-normalised cell.  Padding rows take the
sentinel slot ``nb`` and are dropped by the scatter.  ``brick_conv_xla``
is a k=3 s=1 conv on this layout: a 10³ halo per brick assembled from the
26 neighbouring bricks, then one accumulated GEMM per kernel offset.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .conv import mm_f32
from .coords import SparseGrid

BRICK = 8  # voxels per side; 8³ = 512 rows per brick


class BrickLayout(NamedTuple):
    """Addressing between grid rows and dense brick slots."""

    slot: torch.Tensor  # int32[N]: brick slot per row (nb for padding rows)
    within: torch.Tensor  # int32[N]: voxel index inside the brick [0, 512)
    nb: int  # total brick slots (batch · prod(ceil(cells / 8)))
    bdims: Tuple[int, int, int]  # brick-space dimensions per instance
    batch_size: int


def brick_dims(grid: SparseGrid) -> Tuple[int, int, int]:
    cells = [-(-int(e) // int(s)) for e, s in zip(grid.extent, grid.stride)]
    return tuple(-(-c // BRICK) for c in cells)


def brick_layout(grid: SparseGrid) -> BrickLayout:
    bd = brick_dims(grid)
    nb = grid.batch_size * int(np.prod(bd))
    c = grid.coords
    cell = [torch.div(c[:, i + 1], int(grid.stride[i]), rounding_mode="floor")
            for i in range(3)]
    bx, by, bz = (torch.div(p, BRICK, rounding_mode="floor") for p in cell)
    slot = ((c[:, 0] * bd[0] + bx) * bd[1] + by) * bd[2] + bz
    slot = torch.where(grid.valid, slot, nb).to(torch.int32)
    within = ((cell[0] % BRICK) * BRICK + cell[1] % BRICK) * BRICK + \
        cell[2] % BRICK
    within = torch.where(grid.valid, within, 0).to(torch.int32)
    return BrickLayout(slot=slot, within=within, nb=nb, bdims=bd,
                       batch_size=grid.batch_size)


def to_bricks(features: torch.Tensor, layout: BrickLayout) -> torch.Tensor:
    """[N, C] rows → dense bricks [nb, 512, C]; padding rows drop into the
    sentinel slab, empty cells hold exact zeros."""
    c = features.shape[-1]
    buf = torch.zeros((layout.nb + 1, BRICK ** 3, c), dtype=features.dtype,
                      device=features.device)
    buf[layout.slot.long(), layout.within.long()] = features
    return buf[:-1]


def from_bricks(bricks: torch.Tensor, layout: BrickLayout,
                valid: torch.Tensor) -> torch.Tensor:
    """Dense bricks back to rows; padding rows read a clamped slot and are
    masked to zero."""
    slot = layout.slot.clamp(0, layout.nb - 1).long()
    out = bricks[slot, layout.within.long()]
    ok = valid & (layout.slot < layout.nb)
    return out * ok[:, None].to(out.dtype)


def _neighbor_slots(layout: BrickLayout, device) -> torch.Tensor:
    """int32[27, nb]: the neighbour slot of each slot per brick offset
    (C-order over (dx, dy, dz) ∈ {-1,0,1}³); nb where it is missing."""
    bdx, bdy, bdz = layout.bdims
    nb = layout.nb
    slots = torch.arange(nb, dtype=torch.int64, device=device)
    b, rem = slots // (bdx * bdy * bdz), slots % (bdx * bdy * bdz)
    x, rem = rem // (bdy * bdz), rem % (bdy * bdz)
    y, z = rem // bdz, rem % bdz
    out = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nx, ny, nz = x + dx, y + dy, z + dz
                ok = ((nx >= 0) & (nx < bdx) & (ny >= 0) & (ny < bdy) &
                      (nz >= 0) & (nz < bdz))
                s = ((b * bdx + nx) * bdy + ny) * bdz + nz
                out.append(torch.where(ok, s, nb))
    return torch.stack(out).to(torch.int32)


def _halo(bricks: torch.Tensor, layout: BrickLayout) -> torch.Tensor:
    """[nb, 10, 10, 10, C]: each brick centred in its 1-voxel shell taken
    from the 26 neighbouring bricks (missing neighbours give zeros)."""
    nb, _, c = bricks.shape
    vol = bricks.reshape(nb, BRICK, BRICK, BRICK, c)
    volp = torch.cat([vol, vol.new_zeros((1, BRICK, BRICK, BRICK, c))])
    nbr = _neighbor_slots(layout, bricks.device).long()
    halo = vol.new_zeros((nb, BRICK + 2, BRICK + 2, BRICK + 2, c))

    def src_dst(d):
        # the neighbour at -1 gives its last slice to halo row 0, the one
        # at +1 its first slice to row 9, offset 0 the full extent to 1..8
        if d == -1:
            return slice(BRICK - 1, BRICK), slice(0, 1)
        if d == 1:
            return slice(0, 1), slice(BRICK + 1, BRICK + 2)
        return slice(0, BRICK), slice(1, BRICK + 1)

    k = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                sx, hx = src_dst(dx)
                sy, hy = src_dst(dy)
                sz, hz = src_dst(dz)
                halo[:, hx, hy, hz, :] = volp[:, sx, sy, sz, :][nbr[k]]
                k += 1
    return halo


def brick_conv_xla(bricks: torch.Tensor, kernel: torch.Tensor,
                   layout: BrickLayout) -> torch.Tensor:
    """k=3 s=1 conv on the brick layout: halo, then 27 shifted-slab GEMMs
    accumulated in float32.  ``kernel`` [27, C, Co] in C-order over
    (dx, dy, dz); returns float32 [nb, 512, Co]."""
    nb, _, c = bricks.shape
    co = kernel.shape[-1]
    halo = _halo(bricks, layout)
    out = torch.zeros((nb * BRICK ** 3, co), dtype=torch.float32,
                      device=bricks.device)
    k = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                # out[p] += in[p + d] · W_d: the slab starts at 1 + d
                slab = halo[:, 1 + dx:9 + dx, 1 + dy:9 + dy, 1 + dz:9 + dz]
                out = out + mm_f32(slab.reshape(-1, c), kernel[k])
                k += 1
    return out.reshape(nb, BRICK ** 3, co)
