"""MinkUNet semantic-segmentation family.

Port of `MinkUNetBase` and MinkUNet14/18/34/50/101/34A/34B/34C from
`mink_octtree_stablediffusion_tpu/models/minkunet.py`: a k5 stem, four
k2-s2 down stages with residual blocks, four k2-s2 transposes pinned to
the matching skip grids, each concatenated with its skip, and a 1x1 head
with bias.  The down convs' buffers are ``max(input_capacity // 8^i, 64)``
rows, as in JAX (a level with more cells keeps the lowest keys).

flax infers each layer's input width; here it is written out.  With
``e`` the block's expansion and ``p`` the planes, the stage inputs are::

    stem           in_channels → init_dim
    conv1          init_dim → init_dim         (stride 2)
    block1_*       init_dim, then p0·e          → p0·e
    conv2..conv4   p[i-2]·e → p[i-2]·e         (strides 4, 8, 16)
    block2..4_*    p[i-2]·e, then p[i-1]·e      → p[i-1]·e
    convtr4        p3·e → p4;  cat out_b3  → p4 + p2·e  into block5_0
    convtr5        p4·e → p5;  cat out_b2  → p5 + p1·e  into block6_0
    convtr6        p5·e → p6;  cat out_b1  → p6 + p0·e  into block7_0
    convtr7        p6·e → p7;  cat out_p1  → p7 + init_dim into block8_0
    final          p7·e → out_channels

Names follow the flax tree (``conv0``, ``bn0``, ``conv1_conv``,
``conv1_bn``, ``block{stage}_{i}``, ``convtr4_conv``…, ``final``).
``process_group`` makes every BatchNorm SyncBN.
"""

from __future__ import annotations

from typing import Optional, Sequence, Type

import torch.nn.functional as F
from torch import nn

from ..nn.blocks import ResBasicBlock, ResBottleneck
from ..nn.conv import SparseConv, SparseConvTranspose
from ..nn.init import init_parameters
from ..nn.norm import BatchNorm
from ..tensor import SparseTensor, cat
from ..utils.device import make_generator, resolve_device


def _relu(x: SparseTensor) -> SparseTensor:
    return x.with_features(F.relu(x.features))


class MinkUNetBase(nn.Module):
    """Random weights from ``seed``; a new model is in ``.eval()``."""

    block: Type[ResBasicBlock] = ResBasicBlock
    layers: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2)
    planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96)

    def __init__(self, out_channels: int, in_channels: int = 3,
                 init_dim: int = 32, input_capacity: int = 16384,
                 planes: Optional[Sequence[int]] = None, process_group=None,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        p = tuple(planes or self.planes)
        e = self.block.expansion
        pg = process_group
        caps = [max(input_capacity // (8 ** i), 64) for i in range(5)]
        self.conv0 = SparseConv(in_channels, init_dim, kernel_size=5,
                                device=dev)
        self.bn0 = BatchNorm(init_dim, process_group=pg, device=dev)
        self._cba("conv1", init_dim, init_dim, caps[1], pg, dev)
        self.stages = {}
        cin = self._stage(1, init_dim, p[0], pg, dev)
        for i in (2, 3, 4):  # conv2..conv4, then the stage at that stride
            self._cba(f"conv{i}", cin, cin, caps[i], pg, dev)
            cin = self._stage(i, cin, p[i - 1], pg, dev)
        skips = (p[2] * e, p[1] * e, p[0] * e, init_dim)  # out_b3 .. out_p1
        for j, i in enumerate((4, 5, 6, 7)):  # convtr4..convtr7
            self._cba(f"convtr{i}", cin, p[i], None, pg, dev, transpose=True)
            cin = self._stage(i + 1, p[i] + skips[j], p[i], pg, dev)
        self.final = SparseConv(cin, out_channels, kernel_size=1,
                                use_bias=True, device=dev)
        init_parameters(self, make_generator(seed, dev))
        self.eval()

    def _cba(self, name, cin, cout, cap, pg, dev, transpose=False):
        if transpose:
            conv = SparseConvTranspose(cin, cout, kernel_size=2, stride=2,
                                       device=dev)
        else:
            conv = SparseConv(cin, cout, kernel_size=2, stride=2,
                              out_capacity=cap, device=dev)
        setattr(self, f"{name}_conv", conv)
        setattr(self, f"{name}_bn", BatchNorm(cout, process_group=pg,
                                              device=dev))

    def _stage(self, stage, cin, planes, pg, dev) -> int:
        """Add stage ``stage``'s blocks; → its output width."""
        names = []
        for i in range(self.layers[stage - 1]):
            names.append(f"block{stage}_{i}")
            setattr(self, names[-1], self.block(cin, planes,
                                                process_group=pg, device=dev))
            cin = planes * self.block.expansion
        self.stages[stage] = names
        return cin

    def _run_cba(self, name, x, out_grid=None):
        conv = getattr(self, f"{name}_conv")
        x = conv(x, out_grid) if out_grid is not None else conv(x)
        return _relu(getattr(self, f"{name}_bn")(x))

    def _run_stage(self, stage, x):
        for name in self.stages[stage]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: SparseTensor) -> SparseTensor:
        """→ per-voxel logits on the input's grid."""
        out_p1 = _relu(self.bn0(self.conv0(x)))
        out = self._run_cba("conv1", out_p1)
        out_b1 = self._run_stage(1, out)
        out_b2 = self._run_stage(2, self._run_cba("conv2", out_b1))
        out_b3 = self._run_stage(3, self._run_cba("conv3", out_b2))
        out = self._run_stage(4, self._run_cba("conv4", out_b3))
        for i, skip in zip((4, 5, 6, 7), (out_b3, out_b2, out_b1, out_p1)):
            out = self._run_cba(f"convtr{i}", out, skip.grid)
            out = self._run_stage(i + 1, cat(out, skip))
        return self.final(out)


class MinkUNet14(MinkUNetBase):
    layers = (1, 1, 1, 1, 1, 1, 1, 1)


class MinkUNet18(MinkUNetBase):
    layers = (2, 2, 2, 2, 2, 2, 2, 2)


class MinkUNet34(MinkUNetBase):
    layers = (2, 3, 4, 6, 2, 2, 2, 2)


class MinkUNet50(MinkUNetBase):
    block = ResBottleneck
    layers = (2, 3, 4, 6, 2, 2, 2, 2)


class MinkUNet101(MinkUNetBase):
    block = ResBottleneck
    layers = (2, 3, 4, 23, 2, 2, 2, 2)


class MinkUNet34A(MinkUNet34):
    planes = (32, 64, 128, 256, 256, 128, 64, 64)


class MinkUNet34B(MinkUNet34):
    planes = (32, 64, 128, 256, 256, 128, 64, 32)


class MinkUNet34C(MinkUNet34):
    """The ScanNet segmentation default."""

    planes = (32, 64, 128, 256, 256, 128, 96, 96)
