"""Sorted-order coordinate lookup for bounded grids.

Port of `mink_octtree_stablediffusion_tpu/ops/search.py`, bounded path: a
bounded grid's rows are sorted by their int32 flat cell key, so a lookup is
a lower-bound search of the query's flat key (`torch.searchsorted`, the
same lower bound the JAX package bisects for) followed by the same
fixed-width window check of exact coordinates.
"""

from __future__ import annotations

import torch

from .coords import UNBOUNDED_MSG, _flat_bound, _tuplize, flat_cell_key

_DUP_WINDOW = 4


def lookup_sorted(grid_coords: torch.Tensor, grid_valid: torch.Tensor,
                  stride, queries: torch.Tensor,
                  queries_valid: torch.Tensor | None = None,
                  extent=None, grid_keys: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Row index of each query in the grid; -1 where absent/invalid.
    ``grid_keys`` may pass the grid's precomputed flat keys."""
    n = grid_coords.shape[0]
    d = grid_coords.shape[1] - 1
    st = _tuplize(stride, d)
    if _flat_bound(extent, st, d) is None:
        raise NotImplementedError(UNBOUNDED_MSG)
    qv = (queries_valid if queries_valid is not None else
          torch.ones(queries.shape[0], dtype=torch.bool,
                     device=queries.device))
    gk = (grid_keys if grid_keys is not None else
          flat_cell_key(grid_coords, grid_valid, st, extent))
    qk = flat_cell_key(queries, qv, st, extent)
    lo = torch.searchsorted(gk, qk)
    found = torch.full_like(lo, -1)
    for off in range(_DUP_WINDOW):
        idx = (lo + off).clamp(max=n - 1)
        ok = (lo + off < n) & grid_valid[idx]
        match = ok & (grid_coords[idx] == queries).all(dim=-1)
        found = torch.where((found < 0) & match, idx, found)
    return torch.where(qv, found, -1).to(torch.int32)
