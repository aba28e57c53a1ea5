"""Dense lookup-table coordinate queries for bounded-extent grids.

Port of `mink_octtree_stablediffusion_tpu/ops/lut.py`: row indices are
scattered into a flat ``[B·prod(cells) + 1]`` int32 table, so a coordinate
query is one direct gather.  Used below ``LUT_MAX_ENTRIES``; larger key
spaces take the sorted search (`ops.search`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# max table entries for choosing the LUT path (~8 MB int32)
LUT_MAX_ENTRIES = 2_097_152


def lut_shape(extent: Sequence[int], stride: Sequence[int],
              batch_size: int) -> Tuple[int, ...]:
    cells = tuple(int(np.ceil(e / s)) for e, s in zip(extent, stride))
    return (batch_size,) + cells


def lut_entries(extent, stride, batch_size) -> int:
    return int(np.prod(lut_shape(extent, stride, batch_size)))


def _flat(coords: torch.Tensor, stride, cells, ok: torch.Tensor):
    """(flat cell index, in-range mask, positions) of ``coords``."""
    flat = coords[:, 0]
    pos = []
    for i, c in enumerate(cells):
        p = torch.div(coords[:, 1 + i], stride[i], rounding_mode="floor")
        pos.append(p)
        ok = ok & (p >= 0) & (p < int(c))
        flat = flat * int(c) + p.clamp(0, int(c) - 1)
    return flat, ok, pos


def build_lut(coords: torch.Tensor, valid: torch.Tensor, stride, extent,
              batch_size: int) -> torch.Tensor:
    """Scatter row indices into a flat [B·prod(cells) + 1] table (-1 empty)."""
    shape = lut_shape(extent, stride, batch_size)
    total = int(np.prod(shape))
    b = coords[:, 0]
    ok = valid & (b >= 0) & (b < batch_size)
    flat, ok, _ = _flat(coords, stride, shape[1:], ok)
    dest = torch.where(ok, flat, total).long()
    table = torch.full((total + 1,), -1, dtype=torch.int32,
                       device=coords.device)
    table[dest] = torch.arange(coords.shape[0], dtype=torch.int32,
                               device=coords.device)
    return table


def lut_lookup(table: torch.Tensor, stride, extent, batch_size: int,
               queries: torch.Tensor,
               queries_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Direct-index row lookup; -1 for missing/out-of-extent/invalid and
    for queries off the lattice."""
    shape = lut_shape(extent, stride, batch_size)
    total = int(np.prod(shape))
    b = queries[:, 0]
    ok = (b >= 0) & (b < batch_size)
    if queries_valid is not None:
        ok = ok & queries_valid
    flat, ok, pos = _flat(queries, stride, shape[1:], ok)
    for i, p in enumerate(pos):
        ok = ok & (queries[:, 1 + i] == p * stride[i])
    idx = table[torch.where(ok, flat, total).long()]
    return torch.where(ok, idx, -1)
