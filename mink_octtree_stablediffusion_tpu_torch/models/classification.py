"""ModelNet40 classification models.

Port of `field_slice`, `MinkowskiFCNN` and `MinkowskiSplatFCNN` from
`mink_octtree_stablediffusion_tpu/models/classification.py`: a
``TensorField`` → per-point MLP → voxelize → conv/pool pyramid (strides 2,
8, 32, 128) → each level read back at the points (``field_slice``, or
multilinear ``interpolate_at`` in the splat variant) → concatenated (48 +
64 + 96 + 128 = 336 channels at the default widths) → voxelize again →
three strided embedding convs → global max + avg → the dense head.
Dropout runs in ``.train()`` only when a ``generator`` is given.  Names
follow the flax tree: a block's auto-named ``Dense_0``/``SparseConv_0``/
``BatchNorm_0`` are ``fc``/``conv``/``bn`` (`utils.convert`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv import SparseConv
from ..nn.init import init_parameters
from ..nn.linear import Dense
from ..nn.norm import BatchNorm, DenseBatchNorm
from ..nn.pool import LocalPool, global_pool_features
from ..ops.conv import gather_rows
from ..ops.neighbors import grid_lookup
from ..tensor import SparseTensor, TensorField, interpolate_at
from ..utils.device import make_generator, resolve_device
from .pointnet import dense_dropout


def field_slice(tensor: SparseTensor, field: TensorField) -> torch.Tensor:
    """Features of the voxel holding each field point at the tensor's
    stride [M, C]; zero for a point whose voxel was pooled away (the
    reference's ``.slice()``)."""
    s = torch.as_tensor(tensor.tensor_stride, dtype=torch.float32,
                        device=field.coordinates.device)
    vox = torch.cat([field.coordinates[:, :1].to(torch.int32),
                     (torch.floor(field.coordinates[:, 1:] / s) * s
                      ).to(torch.int32)], dim=-1)
    idx = grid_lookup(tensor.grid, vox, field.valid)
    return gather_rows(tensor.features, idx)


class _MLPBlock(nn.Module):
    """Dense (no bias) → masked BatchNorm → leaky ReLU, per point."""

    def __init__(self, in_channels: int, out_channels: int,
                 process_group=None, device=None):
        super().__init__()
        self.fc = Dense(in_channels, out_channels, bias=False, device=device)
        self.bn = BatchNorm(out_channels, process_group=process_group,
                            device=device)

    def forward(self, x):
        x = self.bn(x.with_features(self.fc(x.features)))
        return x.with_features(F.leaky_relu(x.features))


class _ConvBlock(nn.Module):
    """SparseConv → BatchNorm → leaky ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 out_capacity: Optional[int] = None, process_group=None,
                 device=None):
        super().__init__()
        self.conv = SparseConv(in_channels, out_channels, kernel_size, stride,
                               out_capacity=out_capacity, device=device)
        self.bn = BatchNorm(out_channels, process_group=process_group,
                            device=device)

    def forward(self, x: SparseTensor) -> SparseTensor:
        x = self.bn(self.conv(x))
        return x.with_features(F.leaky_relu(x.features))


class MinkowskiFCNN(nn.Module):
    """Random weights from ``seed``; a new model is in ``.eval()``.
    ``process_group`` makes every sparse BatchNorm SyncBN (JAX's
    ``axis_name``); the dense head's BatchNorms stay local, as in JAX."""

    splat = False

    def __init__(self, out_channel: int = 40, embedding_channel: int = 1024,
                 channels: Sequence[int] = (32, 48, 64, 96, 128),
                 voxel_capacity: int = 4096, in_channels: int = 3,
                 process_group=None, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        ch, pg = tuple(channels), process_group
        self.voxel_capacity = voxel_capacity

        # Level capacities by STRIDE level l (stride 2^l): sampled point
        # clouds merge <2x on the first stride doublings (512 points of a
        # unit sphere at 0.05 voxels occupy ~80% as many stride-2 cells),
        # so early levels keep the full budget and the decay starts at s8.
        # The old cap//8^level schedule overflowed the FIRST pool ~5x, and
        # overflow drops rows in key order — batch 0 sorts first, so every
        # other instance lost ALL its voxels and the classifier sat at
        # chance while batch 0 carried the loss (r2 debugging).
        def lcap(l: int) -> int:
            return max(voxel_capacity >> max(l - 2, 0), 128)

        self.mlp1 = _MLPBlock(in_channels, ch[0], pg, device=dev)
        self.conv1 = _ConvBlock(ch[0], ch[1], 3, 1, None, pg, device=dev)
        self.conv2 = _ConvBlock(ch[1], ch[2], 3, 2, lcap(2), pg, device=dev)
        self.conv3 = _ConvBlock(ch[2], ch[3], 3, 2, lcap(4), pg, device=dev)
        self.conv4 = _ConvBlock(ch[3], ch[4], 3, 2, lcap(6), pg, device=dev)
        self.pools = nn.ModuleList(
            LocalPool(kernel_size=3, stride=2, mode="max",
                      out_capacity=lcap(l)) for l in (1, 3, 5, 7))
        ec = embedding_channel
        cat_ch = sum(ch[1:])  # y1..y4 read back at the points
        self.conv5_0 = _ConvBlock(cat_ch, ec // 4, 3, 2, lcap(1), pg,
                                  device=dev)
        self.conv5_1 = _ConvBlock(ec // 4, ec // 2, 3, 2, lcap(2), pg,
                                  device=dev)
        self.conv5_2 = _ConvBlock(ec // 2, ec, 3, 2, lcap(3), pg, device=dev)
        self.final_0 = Dense(2 * ec, 512, bias=False, device=dev)
        self.final_bn0 = DenseBatchNorm(512, device=dev)
        self.final_1 = Dense(512, 512, bias=False, device=dev)
        self.final_bn1 = DenseBatchNorm(512, device=dev)
        self.final_out = Dense(512, out_channel, device=dev)
        init_parameters(self, make_generator(seed, dev))
        self.eval()

    def _voxelize(self, field: TensorField) -> SparseTensor:
        if self.splat:
            return field.splat(capacity=self.voxel_capacity)
        return field.sparse(capacity=self.voxel_capacity)[0]

    def _read_back(self, t: SparseTensor, field: TensorField):
        if self.splat:
            return interpolate_at(t, field.coordinates, field.valid)
        return field_slice(t, field)

    def forward(self, field: TensorField,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """→ logits [B, out_channel]."""
        y = self._voxelize(self.mlp1(field))
        levels = []
        for conv, pool in zip((self.conv1, self.conv2, self.conv3,
                               self.conv4), self.pools):
            y = pool(conv(y))  # strides 2, 8, 32, 128
            levels.append(y)
        feats = torch.cat([self._read_back(t, field) for t in levels],
                          dim=-1)
        y = self._voxelize(field.with_features(feats))
        y = self.conv5_2(self.conv5_1(self.conv5_0(y)))
        g = torch.cat([global_pool_features(y, "max"),
                       global_pool_features(y, "avg")], dim=-1)
        h = F.leaky_relu(self.final_bn0(self.final_0(g)))
        if self.training and not self.splat:
            h = dense_dropout(h, 0.5, generator)
        h = F.leaky_relu(self.final_bn1(self.final_1(h)))
        return self.final_out(h)


class MinkowskiSplatFCNN(MinkowskiFCNN):
    """The splat variant: the field is splatted onto its lattice corners
    (an unbounded grid) and each level is read back by multilinear
    interpolation; no dropout in the head, as in JAX."""

    splat = True
