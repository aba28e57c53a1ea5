"""SparseTensor: features over a fixed-capacity coordinate set.

Port of `mink_octtree_stablediffusion_tpu/tensor.py` (the parts the
generation path uses).  A :class:`SparseTensor` holds a ``SparseGrid`` and
``features [N_cap, C]``; rows with ``grid.valid == False`` are padding and
hold zero features, an invariant every op preserves.  Two tensors share
geometry iff they hold the *same* grid object (``is``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from .ops.coords import SparseGrid, make_grid
from .ops.reduce import reduce_by_inverse


@dataclass(eq=False)
class SparseTensor:
    grid: SparseGrid
    features: torch.Tensor  # [N_cap, C]

    @property
    def C(self) -> torch.Tensor:  # noqa: N802
        return self.grid.coords

    @property
    def F(self) -> torch.Tensor:  # noqa: N802
        return self.features

    @property
    def valid(self) -> torch.Tensor:
        return self.grid.valid

    @property
    def tensor_stride(self) -> Tuple[int, ...]:
        return self.grid.stride

    @property
    def capacity(self) -> int:
        return self.grid.capacity

    @property
    def num_channels(self) -> int:
        return self.features.shape[-1]

    @property
    def batch_size(self) -> int:
        return self.grid.batch_size

    def count(self) -> torch.Tensor:
        return self.grid.count()

    def replace(self, **kw) -> "SparseTensor":
        return dataclasses.replace(self, **kw)

    def mask_features(self) -> "SparseTensor":
        """Re-assert the padding invariant (zero features on invalid rows)."""
        f = self.features * self.grid.valid[:, None].to(self.features.dtype)
        return self.replace(features=f)

    def with_features(self, features: torch.Tensor) -> "SparseTensor":
        """New tensor on the same grid (masked)."""
        assert features.shape[0] == self.capacity
        return SparseTensor(grid=self.grid, features=features).mask_features()

    def __add__(self, other):
        if isinstance(other, SparseTensor):
            if other.grid is not self.grid:
                raise NotImplementedError(
                    "addition across different grids (the union fallback) "
                    "is not ported yet")
            return self.with_features(self.features + other.features)
        return self.with_features(self.features + other)

    def decomposed_features(self, max_len: int):
        """Pack per-instance features into ``[B, max_len, C]`` + bool mask;
        also returns each row's slot within its instance (for unpacking).
        Rows past ``max_len`` in their instance are dropped."""
        b = self.batch_size
        cap = self.capacity
        dev = self.features.device
        bid = self.grid.batch_ids().long()  # padding → b
        ar = torch.arange(cap, device=dev)
        first = torch.full((b + 1,), cap, dtype=torch.long, device=dev)
        first = first.scatter_reduce(0, bid, torch.where(self.valid, ar, cap),
                                     "amin")
        pos = ar - first[bid.clamp(0, b)]
        ok = self.valid & (pos < max_len)
        dest = torch.where(ok, bid.clamp(0, b) * max_len + pos, b * max_len)
        c = self.num_channels
        packed = torch.zeros((b * max_len + 1, c), dtype=self.features.dtype,
                             device=dev)
        packed[dest] = self.features * ok[:, None].to(self.features.dtype)
        mask = torch.zeros((b * max_len + 1,), dtype=torch.bool, device=dev)
        mask[dest] = ok
        return (packed[:-1].reshape(b, max_len, c),
                mask[:-1].reshape(b, max_len), pos)

    def from_decomposed(self, packed: torch.Tensor,
                        row_position: torch.Tensor) -> "SparseTensor":
        """Inverse of :meth:`decomposed_features`."""
        b, max_len, c = packed.shape
        bid = self.grid.batch_ids().long().clamp(0, b - 1)
        ok = self.valid & (row_position < max_len)
        src = torch.where(ok, bid * max_len +
                          row_position.clamp(0, max_len - 1), 0)
        flat = packed.reshape(b * max_len, c)
        return self.with_features(flat[src] * ok[:, None].to(packed.dtype))


def sparse_tensor(coordinates: torch.Tensor, features: torch.Tensor,
                  capacity: int | None = None, stride=1, batch_size: int = 1,
                  valid: torch.Tensor | None = None,
                  quantization_mode: str = "sum",
                  extent: Optional[Sequence[int]] = None) -> SparseTensor:
    """Build a SparseTensor from possibly-duplicated raw coordinates: dedup
    via sort-unique and reduce duplicate rows per ``quantization_mode``
    (sum | avg | max | first)."""
    n = coordinates.shape[0]
    cap = capacity or n
    v = (valid if valid is not None else
         torch.ones(n, dtype=torch.bool, device=coordinates.device))
    grid, inverse, _ = make_grid(coordinates, v, cap, stride, batch_size,
                                 extent=extent)
    f = reduce_by_inverse(features, inverse, v, cap, mode=quantization_mode)
    return SparseTensor(grid=grid, features=f).mask_features()


def cat(*tensors: SparseTensor) -> SparseTensor:
    """Channel concatenation; requires one shared grid object."""
    g = tensors[0].grid
    assert all(t.grid is g for t in tensors), "cat requires tensors on one grid"
    return SparseTensor(grid=g, features=torch.cat(
        [t.features for t in tensors], dim=-1))
