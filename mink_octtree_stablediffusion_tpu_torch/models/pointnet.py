"""PointNet baselines.

Port of `PointNet` and `MinkowskiPointNet` from
`mink_octtree_stablediffusion_tpu/models/pointnet.py`: the dense `PointNet`
(``[B, N, 3]`` points, a shared Dense-BN-ReLU stack, a max over the
points, an MLP head) and `MinkowskiPointNet` (the same stack per point of
a ``TensorField``, a BatchNorm masked to the valid points, a per-instance
global max pool).  The dense BatchNorms follow flax (``nn.DenseBatchNorm``).
Dropout runs in ``.train()`` only when a ``generator`` is given, as the
JAX package's runs only given a ``dropout_rng``.  Submodule and parameter
names follow the flax tree (``c1_fc``, ``c1_bn``, ``c1_scale``, ``l2``…).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.init import init_parameters
from ..nn.linear import Dense
from ..nn.norm import DenseBatchNorm
from ..ops.pool import global_pool
from ..tensor import TensorField
from ..utils.device import make_generator, resolve_device

_STACK = (("c1", 64), ("c2", 64), ("c3", 64), ("c4", 128))


def dense_dropout(h: torch.Tensor, rate: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each entry with probability 1 − rate,
    scaled by 1 / (1 − rate); the identity without a generator."""
    if generator is None:
        return h
    keep = torch.rand(h.shape, generator=generator, device=h.device,
                      dtype=h.dtype) < 1.0 - rate
    return torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


class PointNet(nn.Module):
    """Dense PointNet; input ``[B, N, in_channels]``.  Random weights from
    ``seed``; a new model is in ``.eval()``."""

    def __init__(self, out_channel: int = 40, embedding_channel: int = 1024,
                 in_channels: int = 3, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.stack = [name for name, _ in _STACK] + ["c5"]
        cin = in_channels
        for name, ch in _STACK + (("c5", embedding_channel),):
            setattr(self, f"{name}_fc", Dense(cin, ch, bias=False, device=dev))
            setattr(self, f"{name}_bn", DenseBatchNorm(ch, device=dev))
            cin = ch
        self.l1_fc = Dense(cin, 512, bias=False, device=dev)
        self.l1_bn = DenseBatchNorm(512, device=dev)
        self.l2 = Dense(512, out_channel, device=dev)
        init_parameters(self, make_generator(seed, dev))
        self.eval()

    def _cbr(self, h, name):
        bn = getattr(self, f"{name}_bn")
        return F.relu(bn(getattr(self, f"{name}_fc")(h)))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for name in self.stack:
            h = self._cbr(h, name)
        h = self._cbr(h.amax(dim=1), "l1")
        if self.training:
            h = dense_dropout(h, 0.5, generator)
        return self.l2(h)


class MinkowskiPointNet(nn.Module):
    """TensorField PointNet: per point Dense → BatchNorm over the valid
    points (its own ``{name}_scale``/``{name}_bias``, the batch's biased
    statistics in train and eval mode alike, as in JAX: no running
    average) → ReLU, then a masked per-instance max pool and the dense
    head.  Random weights from ``seed``; a new model is in ``.eval()``."""

    def __init__(self, out_channel: int = 40, embedding_channel: int = 1024,
                 in_channels: int = 3, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.stack = [name for name, _ in _STACK] + ["c5"]
        cin = in_channels
        for name, ch in _STACK + (("c5", embedding_channel),):
            setattr(self, f"{name}_fc", Dense(cin, ch, bias=False, device=dev))
            self.register_parameter(f"{name}_scale", nn.Parameter(
                torch.ones(ch, device=dev)))
            self.register_parameter(f"{name}_bias", nn.Parameter(
                torch.zeros(ch, device=dev)))
            cin = ch
        self.l1_fc = Dense(cin, 512, bias=False, device=dev)
        self.l1_bn = DenseBatchNorm(512, device=dev)
        self.l2 = Dense(512, out_channel, device=dev)
        init_parameters(self, make_generator(seed, dev))
        self.eval()

    def forward(self, field: TensorField,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = field.features
        v = field.valid
        w = v.to(h.dtype)[:, None]
        for name in self.stack:
            h = getattr(self, f"{name}_fc")(h)
            n = w.sum().clamp(min=1.0)
            mean = (h * w).sum(0) / n
            var = ((h ** 2 * w).sum(0) / n - mean ** 2).clamp(min=0.0)
            h = ((h - mean) * torch.rsqrt(var + 1e-5) *
                 getattr(self, f"{name}_scale") +
                 getattr(self, f"{name}_bias"))
            h = F.relu(h)
        b = field.batch_size
        bid = torch.where(v, field.coordinates[:, 0].to(torch.int32), b)
        g, _ = global_pool(h, bid, b, v, "max")
        g = F.relu(self.l1_bn(self.l1_fc(g)))
        if self.training:
            g = dense_dropout(g, 0.5, generator)
        return self.l2(g)
