"""Normalization layers over sparse tensors.

Port of `BatchNorm` and `StableInstanceNorm` from
`mink_octtree_stablediffusion_tpu/nn/norm.py`.  Statistics are masked:
padding rows never contribute.  The cross-replica sync of `BatchNorm`
(``axis_name``, SyncBN) is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.pool import broadcast_batch, global_pool
from ..tensor import SparseTensor


class BatchNorm(nn.Module):
    """Masked BatchNorm over all valid rows.

    In ``.train()`` it normalises with the batch's mean and **biased**
    variance ``max(E[x²] − mean², 0)`` over the valid rows and moves the
    running buffers in place, ``r = momentum·r + (1 − momentum)·stat`` with
    the same biased variance (``torch.nn.BatchNorm1d`` would store the
    unbiased one).  In ``.eval()`` it uses the running statistics."""

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
        f = x.features
        if self.training:
            w = x.valid.to(f.dtype)[:, None]
            n = w.sum().clamp(min=1.0)
            mean = (f * w).sum(0) / n
            var = ((f ** 2 * w).sum(0) / n - mean ** 2).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (f - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
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
