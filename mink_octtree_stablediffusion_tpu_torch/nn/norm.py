"""Normalization layers over sparse tensors.

Port of `BatchNorm` and `StableInstanceNorm` from
`mink_octtree_stablediffusion_tpu/nn/norm.py`.  Statistics are masked:
padding rows never contribute.  ``DenseBatchNorm`` is flax's own
``nn.BatchNorm`` on a dense ``[..., C]`` array, as the model zoo's dense
heads use it.  SyncBN is `BatchNorm` with a
``process_group`` (JAX's ``axis_name``): the valid-row count, Σx and Σx²
are summed across the group's ranks before the statistics are formed.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.pool import broadcast_batch, global_pool
from ..parallel.mesh import all_reduce_sum
from ..tensor import SparseTensor


class BatchNorm(nn.Module):
    """Masked BatchNorm over all valid rows.

    In ``.train()`` it normalises with the batch's mean and **biased**
    variance ``max(E[x²] − mean², 0)`` over the valid rows and moves the
    running buffers in place, ``r = momentum·r + (1 − momentum)·stat`` with
    the same biased variance (``torch.nn.BatchNorm1d`` would store the
    unbiased one).  In ``.eval()`` it uses the running statistics.

    With a ``process_group`` (SyncBN) the count, Σx and Σx² of train mode
    are summed over the group's ranks, as JAX's ``psum`` over
    ``axis_name``, so ranks with different valid-row counts weigh by rows,
    through a differentiable all-reduce: the cotangents of the three sums
    are summed across the ranks in backward too (``psum``'s transpose).
    Every rank must call the layer in the same order.  ``.eval()`` never
    syncs."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, process_group=None, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.process_group = process_group
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
            n, s1, s2 = w.sum(), (f * w).sum(0), (f ** 2 * w).sum(0)
            if self.process_group is not None:
                c = s1.shape[0]
                n, s1, s2 = all_reduce_sum(
                    torch.cat([n[None], s1, s2]), self.process_group
                ).split([1, c, c])
                n = n[0]
            n = n.clamp(min=1.0)
            mean = s1 / n
            var = (s2 / n - mean ** 2).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (f - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return x.with_features(y)


# flax ``nn.BatchNorm``'s defaults, which every dense head keeps.
DENSE_BN_MOMENTUM = 0.99
DENSE_BN_EPS = 1e-5


class DenseBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` with its defaults over every axis but the last:
    momentum 0.99, ε 1e-5, the batch's mean and **biased** variance
    ``max(E[x²] − mean², 0)`` both to normalise and, in ``.train()``, in
    the running average ``r = 0.99·r + 0.01·stat`` (``torch.nn.BatchNorm1d``
    keeps the unbiased variance and weighs the other way round).  In
    ``.eval()`` it uses the running statistics."""

    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = DENSE_BN_MOMENTUM
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + DENSE_BN_EPS) *
                             self.weight) + \
            self.bias


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
