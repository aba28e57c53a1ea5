"""Per-instance broadcasts (port of `nn/pool.py::broadcast_op`)."""

from __future__ import annotations

import torch

from ..ops.pool import broadcast_batch
from ..tensor import SparseTensor


def broadcast_op(x: SparseTensor, per_batch: torch.Tensor,
                 op: str = "add") -> SparseTensor:
    """Combine per-instance vectors [B, C] with every voxel row."""
    b = broadcast_batch(per_batch, x.grid.batch_ids(), x.valid)
    if op == "add":
        return x.with_features(x.features + b)
    if op == "mul":
        return x.with_features(x.features * b)
    if op == "copy":
        return x.with_features(b)
    raise ValueError(op)
