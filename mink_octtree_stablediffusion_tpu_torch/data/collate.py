"""Host-side batch collation into fixed-capacity buffers.

Port of `collate_pointclouds` and `stack_devices` from
`mink_octtree_stablediffusion_tpu/data/collate.py`: samples are sorted by
size and the largest dropped while the total exceeds ``max_batch_len`` (or
the buffer capacity); batch indices are re-assigned contiguously.  For
data parallelism, each device's collated tuple is stacked on a leading
device axis, and rank r takes row r (``device_row``,
``parallel.shard_batch``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..ops.coords import batched_coordinates_np, pad_to_capacity


def collate_pointclouds(coords_list: Sequence[np.ndarray], capacity: int,
                        max_batch_len: Optional[int] = None,
                        features_list: Optional[Sequence[np.ndarray]] = None,
                        feature_dim: int = 1):
    """→ (coords[capacity, 1+D], valid[capacity], features[capacity, C],
    kept_indices)."""
    budget = min(max_batch_len or capacity, capacity)
    sizes = [len(c) for c in coords_list]
    order = np.argsort(sizes)  # ascending; drop from the large end
    kept = list(order)
    while kept and sum(sizes[i] for i in kept) > budget:
        kept.pop()
    if not kept:
        kept = [int(order[0])]
    kept = sorted(kept)
    coords = batched_coordinates_np([coords_list[i] for i in kept])
    cpad, valid = pad_to_capacity(coords, capacity)
    if features_list is not None:
        feats = np.concatenate([features_list[i] for i in kept], axis=0)
        fpad = np.zeros((capacity, feats.shape[1]), np.float32)
        n = min(len(feats), capacity)
        fpad[:n] = feats[:n]
    else:
        fpad = np.zeros((capacity, feature_dim), np.float32)
        fpad[valid] = 1.0
    return cpad, valid, fpad, kept


def stack_devices(batches: Sequence[tuple]) -> tuple:
    """Stack per-device collated tuples along a new leading device axis."""
    return tuple(np.stack([b[i] for b in batches])
                 for i in range(len(batches[0])))


def device_row(stacked: Sequence[np.ndarray], rank: int) -> tuple:
    """Device ``rank``'s tuple of a ``stack_devices`` batch."""
    return tuple(x[rank] for x in stacked)
