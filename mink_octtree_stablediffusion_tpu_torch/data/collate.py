"""Host-side batch collation into fixed-capacity buffers.

Port of `collate_pointclouds`, `collate_fields` and `stack_devices` from
`mink_octtree_stablediffusion_tpu/data/collate.py`: samples are sorted by
size and the largest dropped while the total exceeds ``max_batch_len`` (or
the buffer capacity); batch indices are re-assigned contiguously.  A
``TensorField`` batch keeps continuous coordinates (``collate_fields``).  For
data parallelism, each device's collated tuple is stacked on a leading
device axis, and rank r takes row r (``device_row``,
``parallel.shard_batch``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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


def collate_fields(coords_list: Sequence[np.ndarray],
                   features_list: Sequence[np.ndarray], capacity: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TensorField collation: continuous batched coordinates
    [capacity, 1+D] (float32, column 0 the sample's index), validity,
    features; points past ``capacity`` are dropped."""
    rows: List[np.ndarray] = []
    for b, c in enumerate(coords_list):
        rows.append(np.concatenate(
            [np.full((len(c), 1), b, np.float32),
             np.asarray(c, np.float32)], axis=1))
    coords = np.concatenate(rows, axis=0)
    n = min(len(coords), capacity)
    cpad = np.zeros((capacity, coords.shape[1]), np.float32)
    cpad[:n] = coords[:n]
    valid = np.zeros((capacity,), bool)
    valid[:n] = True
    feats = np.concatenate(features_list, axis=0)
    fpad = np.zeros((capacity, feats.shape[1]), np.float32)
    fpad[:n] = feats[:n]
    return cpad, valid, fpad


def stack_devices(batches: Sequence[tuple]) -> tuple:
    """Stack per-device collated tuples along a new leading device axis."""
    return tuple(np.stack([b[i] for b in batches])
                 for i in range(len(batches[0])))


def device_row(stacked: Sequence[np.ndarray], rank: int) -> tuple:
    """Device ``rank``'s tuple of a ``stack_devices`` batch."""
    return tuple(x[rank] for x in stacked)
