"""Coordinate engine on bounded grids: fixed-capacity batched voxel sets.

Port of `mink_octtree_stablediffusion_tpu/ops/coords.py`, bounded-grid path
only.  A coordinate set is a :class:`SparseGrid` — ``coords int32[N_cap,
1+D]`` (column 0 = batch index) plus ``valid bool[N_cap]`` with a static
tensor stride and a static spatial ``extent``.  Valid rows come first, in
the canonical order of the row-major flat cell key (``flat_cell_key``);
padding rows hold ``INVALID_COORD`` in every column.

Unbounded grids (``extent=None``: Morton order, hash-table lookups) are not
ported yet and raise ``NotImplementedError`` (ROADMAP.md queue A, item 2).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .kernels import _tuplize

# Stored in every column of padding rows; valid coordinates are bounded by
# the voxelization resolution, far below it.
INVALID_COORD = 1 << 14
INT32_MAX = int(np.iinfo(np.int32).max)

UNBOUNDED_MSG = ("unbounded grids (extent=None: Morton order, hash-table "
                 "lookups) are not ported yet — ROADMAP.md queue A, item 2")

_CONSTS: dict = {}


def device_const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A cached device copy of a small static host array (kernel offsets,
    strides): the host-to-device copy happens once per (value, device), not
    on every layer call."""
    arr = np.ascontiguousarray(np.asarray(values))
    key = (arr.tobytes(), arr.shape, dtype, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.as_tensor(arr).to(dtype=dtype, device=device)
        _CONSTS[key] = t
    return t


@dataclass(eq=False)
class SparseGrid:
    """A deduplicated, canonically ordered batched coordinate set.

    Two tensors share geometry iff they hold the *same* grid object
    (``is``), as in the JAX package."""

    coords: torch.Tensor  # int32[N_cap, 1+D]
    valid: torch.Tensor  # bool[N_cap]
    stride: Tuple[int, ...] = (1, 1, 1)
    batch_size: int = 1
    # static spatial bound: all valid coords lie in [0, extent) per dim
    extent: Optional[Tuple[int, ...]] = None
    _flat_keys: Optional[torch.Tensor] = field(default=None, repr=False)

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    @property
    def ndim(self) -> int:
        return self.coords.shape[1] - 1

    @property
    def device(self) -> torch.device:
        return self.coords.device

    def batch_ids(self) -> torch.Tensor:
        """Batch index per row; padding rows map to segment ``batch_size``."""
        return torch.where(self.valid, self.coords[:, 0], self.batch_size)

    def count(self) -> torch.Tensor:
        return self.valid.sum()

    def flat_keys(self) -> torch.Tensor:
        """``flat_cell_key`` of this grid at its own stride, computed once
        per grid object (the JAX package gets the same sharing from XLA's
        common-subexpression elimination)."""
        if self._flat_keys is None:
            if self.extent is None:
                raise NotImplementedError(UNBOUNDED_MSG)
            self._flat_keys = flat_cell_key(self.coords, self.valid,
                                            self.stride, self.extent)
        return self._flat_keys


def _cells(extent, stride) -> list:
    return [int(np.ceil(e / s)) for e, s in zip(extent, stride)]


def _flat_bound(extent, stride, d) -> int | None:
    """Total flat cells per batch instance if the extent is usable (the
    flat key stays inside int32 with 20 bits of batch headroom)."""
    if extent is None:
        return None
    total = int(np.prod(_cells(extent, stride)))
    if total <= 0 or total >= (1 << 30):
        return None
    return total


def flat_cell_key(coords: torch.Tensor, valid: torch.Tensor, stride,
                  extent) -> torch.Tensor:
    """Injective int32 sort/search key of bounded grids: the row-major
    linearization ``b·prod(cells) + x·(…) + …`` of the stride-normalized
    cell; padding and out-of-extent rows map to INT32_MAX."""
    d = coords.shape[1] - 1
    sa = _tuplize(stride, d)
    key = coords[:, 0]
    ok = valid
    for i, c in enumerate(_cells(extent, sa)):
        pos = torch.div(coords[:, 1 + i], sa[i], rounding_mode="floor")
        ok = ok & (pos >= 0) & (pos < c)
        key = key * c + pos.clamp(0, c - 1)
    return key.masked_fill(~ok, INT32_MAX).to(torch.int32)


def _decode_flat_key(keys: torch.Tensor, valid: torch.Tensor, stride,
                     extent) -> torch.Tensor:
    """Inverse of ``flat_cell_key`` for lattice-aligned coordinates."""
    d = len(extent)
    sa = _tuplize(stride, d)
    cells = _cells(extent, sa)
    total = int(np.prod(cells))
    k = keys.masked_fill(~valid, 0)
    b = k // total
    rem = k % total
    pos = []
    for c in reversed(cells):
        pos.append(rem % c)
        rem = rem // c
    pos = [p * s for p, s in zip(pos[::-1], sa)]
    out = torch.stack([b] + pos, dim=-1).to(torch.int32)
    return out.masked_fill(~valid[:, None], INVALID_COORD)


def unique_coords(coords: torch.Tensor, valid: torch.Tensor, capacity: int,
                  stride=1, extent=None, with_inverse: bool = True,
                  batch_size: Optional[int] = None):
    """Sort-based dedup into a fixed-capacity canonical buffer.

    Returns ``(coords, valid, inverse, count)``: inverse maps each input row
    to its unique row (``capacity`` = dropped/invalid); ``count`` is the
    true unique count (``count > capacity`` means overflow).  Out-of-extent
    valid rows are dropped.  The inverse is a dense-LUT gather when
    ``batch_size`` is given and the key space fits ``LUT_MAX_ENTRIES``,
    else one ``searchsorted``."""
    d = coords.shape[1] - 1
    st = _tuplize(stride, d)
    total_cells = _flat_bound(extent, st, d)
    if total_cells is None:
        raise NotImplementedError(UNBOUNDED_MSG)
    dev = coords.device
    key = flat_cell_key(coords, valid, st, extent)
    sk = torch.sort(key).values
    okv = sk != INT32_MAX
    first = okv.clone()
    first[1:] &= sk[1:] != sk[:-1]
    uid = torch.cumsum(first, 0) - 1
    count = first.sum()
    dest = torch.where(first, uid.clamp(max=capacity), capacity)
    out_keys = torch.full((capacity + 1,), INT32_MAX, dtype=torch.int32,
                          device=dev)
    out_keys[dest] = sk
    out_keys = out_keys[:capacity]
    out_valid = torch.arange(capacity, device=dev) < count.clamp(max=capacity)
    out_coords = _decode_flat_key(out_keys, out_valid, st, extent)
    if not with_inverse:
        return out_coords, out_valid, None, count
    from .lut import LUT_MAX_ENTRIES
    lut_total = batch_size * total_cells if batch_size is not None else None
    if lut_total is not None and lut_total + 1 <= LUT_MAX_ENTRIES:
        lut = torch.full((lut_total + 1,), capacity, dtype=torch.int32,
                         device=dev)
        ldest = torch.where((out_keys != INT32_MAX) & (out_keys < lut_total),
                            out_keys, lut_total)
        lut[ldest.long()] = torch.arange(capacity, dtype=torch.int32,
                                         device=dev)
        okq = (key != INT32_MAX) & (key < lut_total)
        inv = torch.where(okq, lut[torch.where(okq, key, 0).long()], capacity)
    else:
        inv = torch.searchsorted(out_keys, key, out_int32=True)
        hit = out_keys[inv.clamp(max=capacity - 1).long()] == key
        inv = torch.where(hit & (key != INT32_MAX) & (inv < capacity), inv,
                          capacity)
    return out_coords, out_valid, inv.to(torch.int32), count


def make_grid(coords: torch.Tensor, valid: torch.Tensor,
              capacity: int | None = None, stride=1, batch_size: int = 1,
              extent: Sequence[int] | None = None):
    """Dedup + canonicalize raw batched coords → ``(grid, inverse, count)``."""
    d = coords.shape[1] - 1
    capacity = capacity or coords.shape[0]
    uc, uv, inverse, count = unique_coords(coords, valid, capacity, stride,
                                           extent=extent,
                                           batch_size=batch_size)
    grid = SparseGrid(coords=uc, valid=uv, stride=_tuplize(stride, d),
                      batch_size=batch_size,
                      extent=None if extent is None else
                      tuple(int(e) for e in extent))
    return grid, inverse, count


def stride_grid(grid: SparseGrid, stride,
                capacity: int | None = None) -> SparseGrid:
    """Coarsen to tensor stride ``grid.stride * stride`` (floor-rounded)."""
    d = grid.ndim
    s = _tuplize(stride, d)
    new_stride = tuple(int(a * b) for a, b in zip(grid.stride, s))
    cols = [grid.coords[:, 0]] + [
        torch.div(grid.coords[:, 1 + i], ns, rounding_mode="floor") * ns
        for i, ns in enumerate(new_stride)]
    down = torch.stack(cols, dim=-1).masked_fill(~grid.valid[:, None],
                                                 INVALID_COORD)
    uc, uv, _, _ = unique_coords(down, grid.valid, capacity or grid.capacity,
                                 new_stride, extent=grid.extent,
                                 with_inverse=False)
    return SparseGrid(coords=uc, valid=uv, stride=new_stride,
                      batch_size=grid.batch_size, extent=grid.extent)


def expand_grid(grid: SparseGrid, offsets: np.ndarray,
                out_stride: Sequence[int], capacity: int) -> SparseGrid:
    """Generative expansion: unique union of ``coords + offset`` for every
    (absolute, lattice-unit) kernel offset [K, D].  The extent is kept when
    every child stays inside its parent cell (the k2-s2 octree growth);
    otherwise the result would be unbounded, which is not ported yet."""
    k, d = offsets.shape
    keep_extent = grid.extent is not None and offsets.min() >= 0 and all(
        offsets[:, i].max() <= gs - os
        for i, (gs, os) in enumerate(zip(grid.stride, out_stride)))
    if not keep_extent:
        raise NotImplementedError(UNBOUNDED_MSG)
    off = device_const(offsets, torch.int32, grid.device)
    spatial = grid.coords[:, None, 1:] + off[None, :, :]  # [N, K, D]
    batch = grid.coords[:, None, :1].expand(grid.capacity, k, 1)
    cand = torch.cat([batch, spatial], dim=-1).reshape(-1, 1 + d)
    cand_valid = grid.valid.repeat_interleave(k)
    cand = cand.masked_fill(~cand_valid[:, None], INVALID_COORD)
    uc, uv, _, _ = unique_coords(cand, cand_valid, capacity,
                                 tuple(out_stride), extent=grid.extent,
                                 with_inverse=False)
    return SparseGrid(coords=uc, valid=uv,
                      stride=tuple(int(s) for s in out_stride),
                      batch_size=grid.batch_size, extent=grid.extent)


# ---------------------------------------------------------------------------
# Host-side collation helpers (numpy)
# ---------------------------------------------------------------------------


def batched_coordinates_np(coord_list, dtype=np.int32) -> np.ndarray:
    """Prepend the batch index column."""
    rows = []
    for b, c in enumerate(coord_list):
        c = np.asarray(c)
        rows.append(np.concatenate(
            [np.full((len(c), 1), b, dtype=dtype), np.floor(c).astype(dtype)],
            axis=1))
    return np.concatenate(rows, axis=0)


def sparse_quantize_np(coords: np.ndarray, quantization_size=1.0,
                       return_index=False, return_inverse=False):
    """Host-side voxelization: floor-divide by the quantization size and
    dedup, keeping the first occurrence of each voxel."""
    q = np.floor(np.asarray(coords, dtype=np.float64) /
                 quantization_size).astype(np.int32)
    _, index, inverse = np.unique(q, axis=0, return_index=True,
                                  return_inverse=True)
    out = (q[np.sort(index)],)
    if return_index or return_inverse:
        order = np.argsort(index)
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        if return_index:
            out = out + (np.sort(index),)
        if return_inverse:
            out = out + (rank[inverse],)
    return out[0] if len(out) == 1 else out


def pad_to_capacity(coords: np.ndarray, capacity: int):
    """Pad/truncate host coords to the static capacity → (coords, valid)."""
    n = min(len(coords), capacity)
    out = np.full((capacity, coords.shape[1]), INVALID_COORD, dtype=np.int32)
    out[:n] = coords[:n]
    valid = np.zeros((capacity,), dtype=bool)
    valid[:n] = True
    return out, valid
