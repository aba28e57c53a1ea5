"""Generative reconstruction and shape completion.

Port of `_GenLevel`, `_prune_level`, `GenerativeNet` and `CompletionNet`
from `mink_octtree_stablediffusion_tpu/models/completion.py`:
`GenerativeNet` grows a whole shape from one seed voxel per instance
(class one-hot features) through six generative-transpose + pruning
levels; `CompletionNet` is a strided-conv encoder followed by five such
levels.  Each level's 1x1 head scores the grown voxels, the scores are
clamped to the level's buffer (``ops.top_k_mask``: rows tied at the k-th
score are dropped) and, in ``.train()``, the target's voxels are kept too.
Names follow the flax tree (``block{n}`` with ``up``/``bn_up``/``conv``/
``bn_conv``, ``block1_conv2``, ``block{n}_cls``; ``enc{i}``,
``enc{i}_bn``, ``dec{l}``, ``dec{l}_cls``).
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ..nn.conv import GenerativeConvTranspose, SparseConv
from ..nn.init import init_parameters
from ..nn.norm import BatchNorm
from ..ops.coords import SparseGrid, stride_grid
from ..ops.neighbors import membership
from ..ops.pruning import prune, top_k_mask
from ..tensor import SparseTensor
from ..utils.device import make_generator, resolve_device


def _elu(x: SparseTensor) -> SparseTensor:
    return x.with_features(F.elu(x.features))


class _GenLevel(nn.Module):
    """generative transpose k2s2 → bn → elu → conv k3 → bn → elu."""

    def __init__(self, in_channels: int, channels: int, out_capacity: int,
                 process_group=None, device=None):
        super().__init__()
        self.up = GenerativeConvTranspose(in_channels, channels,
                                          out_capacity, kernel_size=2,
                                          stride=2, device=device)
        self.bn_up = BatchNorm(channels, process_group=process_group,
                               device=device)
        self.conv = SparseConv(channels, channels, kernel_size=3,
                               device=device)
        self.bn_conv = BatchNorm(channels, process_group=process_group,
                                 device=device)

    def forward(self, x: SparseTensor) -> SparseTensor:
        x = _elu(self.bn_up(self.up(x)))
        return _elu(self.bn_conv(self.conv(x)))


def _prune_level(out: SparseTensor, logits: SparseTensor,
                 target_grid: SparseGrid, cap: int, train: bool):
    """In this order: the target at the level's stride, membership of the
    grown voxels in it, keep = the top ``cap`` positive scores (``|``
    target in training), prune → (pruned tensor, membership)."""
    strided = stride_grid(target_grid, tuple(out.tensor_stride), capacity=cap)
    target = membership(out.grid, strided)
    keep = top_k_mask(logits.features[:, 0], out.valid, cap)
    if train:
        keep = keep | target
    grid, feats = prune(out.grid, out.features, keep)
    return SparseTensor(grid=grid, features=feats), target


class GenerativeNet(nn.Module):
    """``z`` is one seed voxel per instance at the coarsest stride (2^6),
    its ``in_channels`` features the class one-hot.  ``forward(z,
    target_grid)`` → (per-level logits, per-level membership targets, the
    stride-1 tensor).  Random weights from ``seed``; a new model is in
    ``.eval()``."""

    def __init__(self, in_channels: int,
                 channels: Sequence[int] = (1024, 512, 256, 128, 64, 32, 16),
                 level_capacities: Sequence[int] = (8, 64, 512, 2048, 8192,
                                                    32768),
                 process_group=None, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        ch, pg = tuple(channels), process_group
        self.level_capacities = tuple(level_capacities)
        cin = in_channels
        for lvl in range(6):
            setattr(self, f"block{lvl + 1}", _GenLevel(
                cin, ch[lvl], self.level_capacities[lvl], pg, device=dev))
            cin = ch[lvl]
            if lvl == 0:  # block1 has a second conv pair
                self.block1_conv2 = SparseConv(ch[0], ch[1], kernel_size=3,
                                               device=dev)
                self.block1_bn2 = BatchNorm(ch[1], process_group=pg,
                                            device=dev)
                cin = ch[1]
            setattr(self, f"block{lvl + 1}_cls", SparseConv(
                cin, 1, kernel_size=1, use_bias=True, device=dev))
        init_parameters(self, make_generator(seed, dev))
        self.eval()

    def forward(self, z: SparseTensor, target_grid: SparseGrid):
        out = z
        out_clss, targets = [], []
        for lvl in range(6):
            out = getattr(self, f"block{lvl + 1}")(out)
            if lvl == 0:
                out = _elu(self.block1_bn2(self.block1_conv2(out)))
            logits = getattr(self, f"block{lvl + 1}_cls")(out)
            out, target = _prune_level(out, logits, target_grid,
                                       self.level_capacities[lvl],
                                       self.training)
            out_clss.append(logits)
            targets.append(target)
        return out_clss, targets, out


class CompletionNet(nn.Module):
    """Conv-down encoder (no latent sampling) + the generative pruning
    decoder.  Random weights from ``seed``; a new model is in
    ``.eval()``."""

    def __init__(self, in_channels: int = 1,
                 enc_channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 dec_channels: Sequence[int] = (256, 128, 64, 32, 16, 16),
                 enc_capacities: Sequence[int] = (16384, 4096, 1024, 256, 64,
                                                  16),
                 dec_capacities: Sequence[int] = (64, 256, 1024, 4096,
                                                  16384),
                 process_group=None, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        pg = process_group
        self.dec_capacities = tuple(dec_capacities)
        self.n_enc = len(enc_channels)
        cin = in_channels
        for i, ch in enumerate(enc_channels):
            setattr(self, f"enc{i}", SparseConv(
                cin, ch, kernel_size=3, stride=1 if i == 0 else 2,
                out_capacity=enc_capacities[i] if i > 0 else None,
                device=dev))
            setattr(self, f"enc{i}_bn", BatchNorm(ch, process_group=pg,
                                                  device=dev))
            cin = ch
        for lvl, ch in enumerate(tuple(dec_channels)[:5]):
            setattr(self, f"dec{lvl}", _GenLevel(
                cin, ch, self.dec_capacities[lvl], pg, device=dev))
            setattr(self, f"dec{lvl}_cls", SparseConv(
                ch, 1, kernel_size=1, use_bias=True, device=dev))
            cin = ch
        init_parameters(self, make_generator(seed, dev))
        self.eval()

    def forward(self, sinput: SparseTensor, target_grid: SparseGrid):
        x = sinput
        for i in range(self.n_enc):
            x = _elu(getattr(self, f"enc{i}_bn")(getattr(self, f"enc{i}")(x)))
        out_clss, targets = [], []
        for lvl in range(5):
            x = getattr(self, f"dec{lvl}")(x)
            logits = getattr(self, f"dec{lvl}_cls")(x)
            x, target = _prune_level(x, logits, target_grid,
                                     self.dec_capacities[lvl], self.training)
            out_clss.append(logits)
            targets.append(target)
        return out_clss, targets, x
