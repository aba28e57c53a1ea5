"""SparseTensor and TensorField: the central data types.

Port of `mink_octtree_stablediffusion_tpu/tensor.py`.  A
:class:`SparseTensor` holds a ``SparseGrid`` and ``features [N_cap, C]``;
rows with ``grid.valid == False`` are padding and hold zero features, an
invariant every op preserves.  Two tensors share geometry iff they hold
the *same* grid object (``is``); arithmetic across two grids adds through
their union (`ops.union`), as the reference's union fallback does.  A
:class:`TensorField` is a set of continuous points with features, which
voxelizes (``sparse``, ``splat``) onto a grid and reads back
(``slice_to_field``, ``interpolate_at``).
"""

from __future__ import annotations

import dataclasses
import operator
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.coords import INVALID_COORD, SparseGrid, _tuplize, make_grid
from .ops.interp import interpolate, splat, splat_coordinates
from .ops.reduce import reduce_by_inverse, slice_by_inverse
from .ops.union import union as _union


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

    def _binary(self, other, fn):
        """``fn`` on the features: with a scalar or tensor, or another
        SparseTensor on the same grid; across grids only ``+``, through
        the union of the two grids."""
        if isinstance(other, SparseTensor):
            if other.grid is self.grid:
                return self.with_features(fn(self.features, other.features))
            if fn is not operator.add:
                raise ValueError(
                    "mismatched-coordinate arithmetic supports + only "
                    "(reference union fallback is additive)")
            g, f = _union([self.grid, other.grid],
                          [self.features, other.features])
            return SparseTensor(grid=g, features=f).mask_features()
        return self.with_features(fn(self.features, other))

    def __add__(self, other):
        return self._binary(other, operator.add)

    def __sub__(self, other):
        return self._binary(other, operator.sub)

    def __mul__(self, other):
        return self._binary(other, operator.mul)

    def __truediv__(self, other):
        return self._binary(other, operator.truediv)

    def __neg__(self):
        return self.with_features(-self.features)

    def dense(self, shape: Sequence[int],
              min_coordinate: Sequence[int] | None = None) -> torch.Tensor:
        """Densify to ``[B, C, *shape]`` (channel first, as the reference):
        voxel ``(coords − min_coordinate) // stride``; rows outside
        ``shape`` are dropped."""
        d = self.grid.ndim
        mins = (np.zeros(d, np.int32) if min_coordinate is None else
                np.asarray(min_coordinate, np.int32))
        dev = self.features.device
        mins = torch.as_tensor(mins, device=dev)
        stride = torch.as_tensor(np.asarray(self.grid.stride, np.int32),
                                 device=dev)
        xyz = torch.div(self.C[:, 1:] - mins, stride, rounding_mode="floor")
        b = self.C[:, 0]
        shape = tuple(int(s) for s in shape)
        in_range = self.valid
        flat = torch.zeros_like(b)
        for i, s in enumerate(shape):
            in_range = in_range & (xyz[:, i] >= 0) & (xyz[:, i] < s)
            flat = flat * s + xyz[:, i].clamp(0, s - 1)
        flat_sz = int(np.prod(shape))
        dest = torch.where(in_range, b * flat_sz + flat,
                           self.batch_size * flat_sz).long()
        c = self.num_channels
        out = self.features.new_zeros((self.batch_size * flat_sz + 1, c))
        out.index_add_(0, dest, self.features *
                       in_range[:, None].to(self.features.dtype))
        dense = out[:-1].reshape((self.batch_size,) + shape + (c,))
        return torch.movedim(dense, -1, 1)

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


@dataclass(eq=False)
class TensorField:
    """Continuous-coordinate points with features (the reference's
    ``TensorField``).  ``sparse`` voxelizes onto a lattice and returns the
    inverse map with which ``slice_to_field`` reads the voxels back.  A
    set ``extent`` (all voxelized coordinates in [0, extent) per
    dimension) makes every derived grid bounded, so its convs take the
    fused route; without it they are unbounded."""

    coordinates: torch.Tensor  # float32[M, 1+D]; column 0 = batch index
    features: torch.Tensor  # [M, C]
    valid: torch.Tensor  # bool[M]
    batch_size: int = 1
    extent: Optional[Sequence[int]] = None

    @property
    def C(self) -> torch.Tensor:  # noqa: N802
        return self.coordinates

    @property
    def F(self) -> torch.Tensor:  # noqa: N802
        return self.features

    @property
    def capacity(self) -> int:
        return self.coordinates.shape[0]

    @property
    def num_channels(self) -> int:
        return self.features.shape[-1]

    def replace(self, **kw) -> "TensorField":
        return dataclasses.replace(self, **kw)

    def with_features(self, features: torch.Tensor) -> "TensorField":
        return self.replace(
            features=features * self.valid[:, None].to(features.dtype))

    def sparse(self, capacity: int | None = None, stride=1,
               quantization_mode: str = "avg"):
        """Voxelize → ``(SparseTensor, inverse)``: each point's voxel is
        ``floor(x / stride) · stride``; the features of a voxel's points
        are reduced by ``quantization_mode`` (avg by default, as the
        reference's UNWEIGHTED_AVERAGE)."""
        d = self.coordinates.shape[1] - 1
        st = _tuplize(stride, d)
        s = torch.as_tensor(st, dtype=torch.float32,
                            device=self.coordinates.device)
        vox = torch.cat([self.coordinates[:, :1].to(torch.int32),
                         (torch.floor(self.coordinates[:, 1:] / s) * s
                          ).to(torch.int32)], dim=-1)
        vox = vox.masked_fill(~self.valid[:, None], INVALID_COORD)
        cap = capacity or self.capacity
        grid, inverse, _ = make_grid(vox, self.valid, cap, st,
                                     self.batch_size, extent=self.extent)
        f = reduce_by_inverse(self.features, inverse, self.valid, cap,
                              mode=quantization_mode)
        return SparseTensor(grid=grid, features=f).mask_features(), inverse

    def splat(self, capacity: int | None = None, stride=1) -> SparseTensor:
        """Multilinear splat onto the points' surrounding lattice corners,
        an unbounded grid of ``capacity`` (default M·2^D) rows."""
        d = self.coordinates.shape[1] - 1
        cap = capacity or self.capacity * 2 ** d
        grid = splat_coordinates(self.coordinates, self.valid, stride, cap,
                                 self.batch_size)
        f = splat(grid, self.coordinates, self.valid, self.features)
        return SparseTensor(grid=grid, features=f).mask_features()


def slice_to_field(tensor: SparseTensor, field: TensorField,
                   inverse: torch.Tensor) -> TensorField:
    """Each point gets its voxel's features (the reference's
    ``SparseTensor.slice``)."""
    return field.with_features(
        slice_by_inverse(tensor.features, inverse, field.valid))


def interpolate_at(tensor: SparseTensor, points: torch.Tensor,
                   points_valid: torch.Tensor) -> torch.Tensor:
    """Multilinear sampling of the tensor at continuous points (the
    reference's ``features_at_coordinates``)."""
    return interpolate(tensor.grid, tensor.features, points, points_valid)


def _one_grid(tensors) -> None:
    g = tensors[0].grid
    if not all(t.grid is g for t in tensors):
        raise ValueError("the tensors must share one grid object")


def stack_sum(*tensors: SparseTensor) -> SparseTensor:
    _one_grid(tensors)
    return tensors[0].with_features(sum(t.features for t in tensors))


def stack_mean(*tensors: SparseTensor) -> SparseTensor:
    _one_grid(tensors)
    return tensors[0].with_features(
        sum(t.features for t in tensors) / float(len(tensors)))


def stack_var(*tensors: SparseTensor) -> SparseTensor:
    """Elementwise variance across the tensors (population variance)."""
    _one_grid(tensors)
    n = float(len(tensors))
    mean = sum(t.features for t in tensors) / n
    return tensors[0].with_features(
        sum((t.features - mean) ** 2 for t in tensors) / n)


def to_sparse_dense(dense: torch.Tensor, capacity: int,
                    stride=1) -> SparseTensor:
    """Dense ``[B, C, *spatial]`` → SparseTensor of its nonzero voxels, an
    unbounded grid (the reference's ``to_sparse``); nonzero voxels beyond
    ``capacity`` (in row-major order) are dropped."""
    b, c = dense.shape[0], dense.shape[1]
    spatial = dense.shape[2:]
    total = int(np.prod(spatial))
    x = torch.movedim(dense, 1, -1).reshape(-1, c)  # [B·prod, C]
    nz = (x != 0).any(dim=-1)
    idx = torch.arange(x.shape[0], device=dense.device)
    cols = [idx // total]
    rem = idx % total
    for i, s in enumerate(spatial):
        trail = int(np.prod(spatial[i + 1:]))
        cols.append((rem // trail) % s)
    coords = torch.stack(cols, dim=-1).to(torch.int32)
    coords = coords.masked_fill(~nz[:, None], INVALID_COORD)
    order = torch.argsort((~nz).to(torch.uint8), stable=True)[:capacity]
    sel_valid = nz[order]
    grid, inverse, _ = make_grid(coords[order], sel_valid, capacity, stride,
                                 b)
    f = reduce_by_inverse(x[order], inverse, sel_valid, capacity, mode="sum")
    return SparseTensor(grid=grid, features=f).mask_features()


def cat_slice(tensor: SparseTensor, field: TensorField,
              inverse: torch.Tensor) -> TensorField:
    """Each point's own features followed by its voxel's (the reference's
    ``SparseTensor.cat_slice``)."""
    sliced = slice_by_inverse(tensor.features, inverse, field.valid)
    return field.with_features(torch.cat([field.features, sliced], dim=-1))


def dense_coordinates(shape: Sequence[int], batch_size: int = 1,
                      device=None) -> torch.Tensor:
    """Every batched coordinate of a dense grid, int32 [B·prod(shape),
    1+D], batch-major then row-major."""
    spatial = tuple(int(s) for s in shape)
    axes = [np.arange(s, dtype=np.int32) for s in spatial]
    mesh = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(
        -1, len(spatial))
    rows = np.concatenate(
        [np.repeat(np.arange(batch_size, dtype=np.int32), len(mesh))[:, None],
         np.tile(mesh, (batch_size, 1))], axis=1)
    return torch.as_tensor(rows, device=device)
