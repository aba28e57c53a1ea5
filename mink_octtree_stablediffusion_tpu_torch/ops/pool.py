"""Sparse pooling: local (kernel neighbourhood) and global (per instance).

Port of `local_pool_apply`, `global_pool` and `broadcast_batch` from
`mink_octtree_stablediffusion_tpu/ops/pool.py`.  Local pooling reduces
over the same padded kernel maps as the convolution.  Global sum/avg are a
masked one-hot ``[B, N] x [N, C]`` matmul with float32 accumulation, as in
JAX (deterministic: no atomics); the broadcast back is a masked row
gather, which equals the JAX one-hot product exactly (one non-zero per
row).  None of these has a Pallas kernel in the JAX package.
"""

from __future__ import annotations

import torch

from .conv import gather_rows


def local_pool_apply(features: torch.Tensor, nbr_idx: torch.Tensor,
                     mode: str = "avg"):
    """Sum/avg/max over the kernel neighbourhood of every output row, for
    ``nbr_idx int32[K, N_out]`` (-1: no neighbour) → (out [N_out, C],
    num_nonzero [N_out]).  A row without a neighbour gives 0 with a zero
    gradient.  Max pooling takes ``amax``, which splits the gradient
    evenly among tied elements, as JAX's ``max`` does."""
    present = nbr_idx >= 0
    num = present.to(features.dtype).sum(0)
    if mode == "max":
        g = torch.stack([gather_rows(features, ix) for ix in nbr_idx])
        g = g.masked_fill(~present[:, :, None], float("-inf"))
        return torch.where(num[:, None] > 0, g.amax(0), 0.0), num
    acc = torch.zeros((nbr_idx.shape[1], features.shape[1]),
                      dtype=features.dtype, device=features.device)
    for ix in nbr_idx:
        acc = acc + gather_rows(features, ix)
    if mode == "sum":
        return acc, num
    if mode == "avg":
        return acc / num.clamp(min=1.0)[:, None], num
    raise ValueError(mode)


def _batch_onehot(batch_ids, num_batches, valid, dtype):
    """[B, N] masked one-hot of the batch column."""
    seg = torch.where(valid, batch_ids, num_batches)
    ar = torch.arange(num_batches, device=batch_ids.device)
    return (seg[None, :] == ar[:, None]).to(dtype)


def global_pool(features: torch.Tensor, batch_ids: torch.Tensor,
                num_batches: int, valid: torch.Tensor, mode: str = "avg"):
    """Per-instance reduction to [B, C] → (pooled, counts [B])."""
    oh = _batch_onehot(batch_ids, num_batches, valid, features.dtype)
    counts = oh.sum(dim=1)
    if mode == "max":
        g = features.masked_fill(~valid[:, None], float("-inf"))
        seg = torch.where(valid, batch_ids, num_batches).long()
        out = torch.full((num_batches + 1, features.shape[1]), float("-inf"),
                         dtype=features.dtype, device=features.device)
        out = out.scatter_reduce(0, seg[:, None].expand_as(g), g, "amax")
        out = out[:num_batches]
        return torch.where(counts[:, None] > 0, out, 0.0), counts
    s = (oh.float() @ features.float()).to(features.dtype)
    if mode == "sum":
        return s, counts
    if mode == "avg":
        return s / counts.clamp(min=1.0)[:, None], counts
    raise ValueError(mode)


def broadcast_batch(per_batch: torch.Tensor, batch_ids: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Broadcast per-instance vectors back to every voxel row [N, C]
    (zero on invalid rows)."""
    b = per_batch.shape[0]
    rows = per_batch[batch_ids.clamp(0, b - 1).long()]
    return rows * valid[:, None].to(per_batch.dtype)
