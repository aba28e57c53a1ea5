"""Sorted-order coordinate lookup.

Port of `mink_octtree_stablediffusion_tpu/ops/search.py`.  A grid's rows
are in canonical order, so a lookup is a lower-bound search of the
query's sort key followed by a fixed-width window check of the exact
coordinates:

- bounded grids: the int32 flat cell key;
- other grids: the (batch, Morton) pair, searched as one int64
  ``batch·2³¹ + morton``; padding rows take ``INT32_MAX`` in both.

``torch.searchsorted`` finds the same lower bound as the JAX package's
branch-free bisection.  Morton codes clip each stride-normalised
coordinate to ±2^(30/D−1) cells (±512 for D=3), so rows beyond that share
codes; the window scans ``_DUP_WINDOW`` rows of such a run and misses a
match past them, as the JAX package does.
"""

from __future__ import annotations

import torch

from .coords import INT32_MAX, _flat_bound, _tuplize, flat_cell_key
from .morton import morton_encode

_DUP_WINDOW = 4


def _keys(coords: torch.Tensor, valid: torch.Tensor, stride) -> torch.Tensor:
    """int64 ``batch·2³¹ + morton``, the (batch, Morton) pair in one key."""
    m = morton_encode(coords[:, 1:], stride).masked_fill(~valid, INT32_MAX)
    b = coords[:, 0].masked_fill(~valid, INT32_MAX)
    return (b.to(torch.int64) << 31) + m.to(torch.int64)


def lookup_sorted(grid_coords: torch.Tensor, grid_valid: torch.Tensor,
                  stride, queries: torch.Tensor,
                  queries_valid: torch.Tensor | None = None,
                  extent=None, grid_keys: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Row index of each query in the grid; -1 where absent/invalid.
    ``extent`` is the grid's; ``grid_keys`` may pass a bounded grid's
    precomputed flat keys."""
    n = grid_coords.shape[0]
    d = grid_coords.shape[1] - 1
    st = _tuplize(stride, d)
    qv = (queries_valid if queries_valid is not None else
          torch.ones(queries.shape[0], dtype=torch.bool,
                     device=queries.device))
    if _flat_bound(extent, st, d) is not None:
        gk = (grid_keys if grid_keys is not None else
              flat_cell_key(grid_coords, grid_valid, st, extent))
        qk = flat_cell_key(queries, qv, st, extent)
    else:
        gk = _keys(grid_coords, grid_valid, st)
        qk = _keys(queries, qv, st)
    lo = torch.searchsorted(gk, qk)
    found = torch.full_like(lo, -1)
    for off in range(_DUP_WINDOW):
        idx = (lo + off).clamp(max=n - 1)
        ok = (lo + off < n) & grid_valid[idx]
        match = ok & (grid_coords[idx] == queries).all(dim=-1)
        found = torch.where((found < 0) & match, idx, found)
    return torch.where(qv, found, -1).to(torch.int32)
