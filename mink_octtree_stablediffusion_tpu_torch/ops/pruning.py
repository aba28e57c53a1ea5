"""Pruning and compaction of sparse tensors.

Port of `mink_octtree_stablediffusion_tpu/ops/pruning.py`: a keep-mask
yields a new grid holding only the kept rows, compacted stably (kept rows
first), so the canonical order survives.
"""

from __future__ import annotations

import torch

from .coords import INVALID_COORD, SparseGrid


def prune(grid: SparseGrid, features: torch.Tensor, keep: torch.Tensor,
          capacity: int | None = None):
    """Keep rows where ``keep`` (and valid) → (grid, features)."""
    cap = capacity or grid.capacity
    keep = keep & grid.valid
    order = torch.argsort((~keep).to(torch.uint8), stable=True)[:cap]
    new_valid = keep[order]
    new_coords = grid.coords[order].masked_fill(~new_valid[:, None],
                                                INVALID_COORD)
    new_feats = features[order] * new_valid[:, None].to(features.dtype)
    return (SparseGrid(coords=new_coords, valid=new_valid, stride=grid.stride,
                       batch_size=grid.batch_size, extent=grid.extent),
            new_feats)


def top_k_mask(logits: torch.Tensor, valid: torch.Tensor,
               k_max: int) -> torch.Tensor:
    """keep = logits > 0, clamped to at most ``k_max`` rows by threshold:
    when more than ``k_max`` rows are positive, keep strictly
    ``score > max(kth, 0)`` — rows tied at the k-th value are dropped."""
    score = torch.where(valid, logits, float("-inf"))
    keep = score > 0.0
    n_keep = keep.sum()
    kth = torch.sort(score, descending=True).values[
        min(k_max, score.shape[0]) - 1]
    clamped = score > kth.clamp(min=0.0)
    return torch.where(n_keep > k_max, clamped, keep)
