"""Normalization layers over sparse tensors.

Port of `BatchNorm` (eval mode: running statistics) and
`StableInstanceNorm` from `mink_octtree_stablediffusion_tpu/nn/norm.py`.
Statistics are masked: padding rows never contribute.  BatchNorm's train
mode (batch statistics and running-average updates) belongs to the
training path, which is not ported yet (ROADMAP.md queue A, item 8).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.pool import broadcast_batch, global_pool
from ..tensor import SparseTensor


class BatchNorm(nn.Module):
    """Masked BatchNorm, evaluated with its running statistics."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(num_features, device=device))
        self.bias = nn.Parameter(torch.empty(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: SparseTensor) -> SparseTensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm train mode is not ported yet (ROADMAP.md queue A, "
                "item 8); call .eval()")
        y = ((x.features - self.running_mean) *
             torch.rsqrt(self.running_var + self.eps) * self.weight + self.bias)
        return x.with_features(y)


class StableInstanceNorm(nn.Module):
    """Group-averaged instance norm: per-instance mean/var are averaged over
    groups of ``g = min(group, C)`` consecutive channels, with one affine
    (weight, bias) per group; ``1/sqrt(var + eps)`` without a clamp."""

    def __init__(self, num_channels: int, group: int = 1, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.g = min(group, num_channels)
        assert num_channels % self.g == 0, (
            f"channels {num_channels} not divisible by group {self.g}")
        ng = num_channels // self.g
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(ng, device=device))
        self.bias = nn.Parameter(torch.empty(ng, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: SparseTensor) -> SparseTensor:
        g = self.g
        ng = x.num_channels // g

        def group_avg(v):  # [B, C] → group-averaged, re-expanded [B, C]
            return v.reshape(-1, ng, g).mean(-1).repeat_interleave(g, dim=-1)

        bid = x.grid.batch_ids()
        mean_b, _ = global_pool(x.features, bid, x.batch_size, x.valid, "avg")
        centered = ((x.features - broadcast_batch(group_avg(mean_b), bid,
                                                  x.valid)) *
                    x.valid[:, None].to(x.features.dtype))
        var_b, _ = global_pool(centered ** 2, bid, x.batch_size, x.valid,
                               "avg")
        inv = 1.0 / torch.sqrt(group_avg(var_b) + self.eps)
        y = centered * broadcast_batch(inv, bid, x.valid)
        return x.with_features(y * self.weight.repeat_interleave(g) +
                               self.bias.repeat_interleave(g))
