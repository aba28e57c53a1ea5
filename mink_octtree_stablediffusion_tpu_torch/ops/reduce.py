"""Row reductions along inverse maps.

Port of `reduce_by_inverse` from
`mink_octtree_stablediffusion_tpu/ops/reduce.py`: duplicate input rows are
reduced onto their unique row (the quantization modes of `sparse_tensor`).
"""

from __future__ import annotations

import torch


def reduce_by_inverse(features: torch.Tensor, inverse: torch.Tensor,
                      valid: torch.Tensor, capacity: int,
                      mode: str = "avg") -> torch.Tensor:
    """Reduce input rows onto their unique row → [capacity, C]; ``inverse``
    == capacity marks a dropped row."""
    dest = torch.where(valid, inverse, capacity).long()
    c = features.shape[1]
    f = features * valid[:, None].to(features.dtype)
    dev, dt = features.device, features.dtype
    if mode in ("sum", "avg"):
        acc = torch.zeros((capacity + 1, c), dtype=dt, device=dev)
        acc.index_add_(0, dest, f)
        if mode == "avg":
            cnt = torch.zeros((capacity + 1,), dtype=dt, device=dev)
            cnt.index_add_(0, dest, valid.to(dt))
            acc = acc / cnt.clamp(min=1.0)[:, None]
        return acc[:capacity]
    if mode == "max":
        acc = torch.full((capacity + 1, c), float("-inf"), dtype=dt,
                         device=dev)
        src = features.masked_fill(~valid[:, None], float("-inf"))
        acc = acc.scatter_reduce(0, dest[:, None].expand(-1, c), src, "amax")
        acc = acc[:capacity]
        return torch.where(torch.isfinite(acc), acc, 0.0)
    if mode == "first":
        n = features.shape[0]
        rows = torch.arange(n, device=dev)
        winner = torch.full((capacity + 1,), n, dtype=torch.long, device=dev)
        winner = winner.scatter_reduce(0, dest, torch.where(valid, rows, n),
                                       "amin")
        took = winner[:capacity] < n
        return (features[winner[:capacity].clamp(max=n - 1)] *
                took[:, None].to(dt))
    raise ValueError(mode)
