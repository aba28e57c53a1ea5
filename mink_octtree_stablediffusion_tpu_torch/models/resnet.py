"""Sparse ResNet classifiers.

Port of `ResNetBase` and ResNet14/18/34/50/101 from
`mink_octtree_stablediffusion_tpu/models/resnet.py`: a k3 s2 conv stem →
bn → relu → k2 s2 max pool → four residual stages (the first block of each
strided) → a 1x1 conv with bias → global average pool → a dense head.
Each strided layer's buffer is ``max(input_capacity // 8^(i+1), 64)``
rows, as in JAX.  ``process_group`` makes every BatchNorm SyncBN (JAX's
``axis_name``).  Submodule names follow the flax tree (``conv1``, ``bn1``,
``layer{stage}_{i}``, ``conv5``, ``final``).
"""

from __future__ import annotations

from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import ResBasicBlock, ResBottleneck
from ..nn.conv import SparseConv
from ..nn.init import init_parameters
from ..nn.linear import Dense
from ..nn.norm import BatchNorm
from ..nn.pool import LocalPool, global_pool_features
from ..tensor import SparseTensor
from ..utils.device import make_generator, resolve_device


class ResNetBase(nn.Module):
    """Random weights from ``seed``; a new model is in ``.eval()``."""

    block: Type[ResBasicBlock] = ResBasicBlock
    layers: Sequence[int] = (1, 1, 1, 1)

    def __init__(self, out_channels: int = 40, in_channels: int = 1,
                 planes: Sequence[int] = (64, 128, 256, 512),
                 init_dim: int = 64, input_capacity: int = 4096,
                 process_group=None, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        pg = process_group
        caps = [max(input_capacity // (8 ** (i + 1)), 64) for i in range(6)]
        self.conv1 = SparseConv(in_channels, init_dim, kernel_size=3,
                                stride=2, out_capacity=caps[0], device=dev)
        self.bn1 = BatchNorm(init_dim, process_group=pg, device=dev)
        self.pool = LocalPool(kernel_size=2, stride=2, mode="max",
                              out_capacity=caps[1])
        self.blocks = []
        cin = init_dim
        for stage, (n, p) in enumerate(zip(self.layers, planes)):
            for i in range(n):
                name = f"layer{stage + 1}_{i}"
                setattr(self, name, self.block(
                    cin, p, stride=2 if i == 0 else 1,
                    out_capacity=caps[min(stage + 2, 5)] if i == 0 else None,
                    process_group=pg, device=dev))
                self.blocks.append(name)
                cin = p * self.block.expansion
        self.conv5 = SparseConv(cin, cin, kernel_size=1, use_bias=True,
                                device=dev)
        self.final = Dense(cin, out_channels, device=dev)
        init_parameters(self, make_generator(seed, dev))
        self.eval()

    def forward(self, x: SparseTensor) -> torch.Tensor:
        """→ logits [B, out_channels]."""
        x = self.bn1(self.conv1(x))
        x = self.pool(x.with_features(F.relu(x.features)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.final(global_pool_features(self.conv5(x), "avg"))


class ResNet14(ResNetBase):
    layers = (1, 1, 1, 1)


class ResNet18(ResNetBase):
    layers = (2, 2, 2, 2)


class ResNet34(ResNetBase):
    layers = (3, 4, 6, 3)


class ResNet50(ResNetBase):
    block = ResBottleneck
    layers = (3, 4, 6, 3)


class ResNet101(ResNetBase):
    block = ResBottleneck
    layers = (3, 4, 23, 3)
