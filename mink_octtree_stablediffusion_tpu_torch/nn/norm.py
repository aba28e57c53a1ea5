"""Normalization layers over sparse tensors.

Port of `mink_octtree_stablediffusion_tpu/nn/norm.py`: `BatchNorm`, the
instance norms (`InstanceNorm`, `StableInstanceNorm`, `StableGroupNorm`,
the AdaIN `AdaStableInstanceNorm`, the per-instance BatchNorm
`HjmInstanceNorm`) and the dense `GroupNormDense`.  Statistics are masked:
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
from .linear import Dense


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


def _instance_moments(x: SparseTensor):
    """Per-instance per-channel (mean [B, C], biased var [B, C], the
    centred features, the batch column), over the valid rows."""
    bid = x.grid.batch_ids()
    mean_b, _ = global_pool(x.features, bid, x.batch_size, x.valid, "avg")
    centered = ((x.features - broadcast_batch(mean_b, bid, x.valid)) *
                x.valid[:, None].to(x.features.dtype))
    var_b, _ = global_pool(centered ** 2, bid, x.batch_size, x.valid, "avg")
    return mean_b, var_b, centered, bid


class _Affine(nn.Module):
    """A per-channel ``weight`` (ones) and ``bias`` (zeros)."""

    def __init__(self, num_channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


class InstanceNorm(_Affine):
    """Per-instance normalization (the reference's
    ``MinkowskiInstanceNorm``): ``rsqrt(var + eps)`` of each instance's
    biased variance, a per-channel affine."""

    def __init__(self, num_channels: int, eps: float = 1e-6, device=None):
        super().__init__(num_channels, device)
        self.eps = eps

    def forward(self, x: SparseTensor) -> SparseTensor:
        _, var_b, centered, bid = _instance_moments(x)
        y = centered * broadcast_batch(torch.rsqrt(var_b + self.eps), bid,
                                       x.valid)
        return x.with_features(y * self.weight + self.bias)


class StableGroupNorm(_Affine):
    """``MinkowskiStableGroupNorm``: each instance's mean and variance
    averaged over all channels, ``1/sqrt(var + eps)``, a per-channel
    affine."""

    def __init__(self, num_channels: int, eps: float = 1e-6, device=None):
        super().__init__(num_channels, device)
        self.eps = eps

    def forward(self, x: SparseTensor) -> SparseTensor:
        bid = x.grid.batch_ids()
        mean_b, _ = global_pool(x.features, bid, x.batch_size, x.valid,
                                "avg")
        mean_b = mean_b.mean(-1, keepdim=True).expand_as(mean_b)
        centered = ((x.features - broadcast_batch(mean_b, bid, x.valid)) *
                    x.valid[:, None].to(x.features.dtype))
        var_b, _ = global_pool(centered ** 2, bid, x.batch_size, x.valid,
                               "avg")
        var_b = var_b.mean(-1, keepdim=True).expand_as(var_b)
        y = centered * broadcast_batch(1.0 / torch.sqrt(var_b + self.eps),
                                       bid, x.valid)
        return x.with_features(y * self.weight + self.bias)


class AdaStableInstanceNorm(_Affine):
    """AdaIN conditioning: instance-normalize, then ``(x̂·w + b)·(1 +
    scale) + shift``, where (scale, shift) ``[B, C]`` each come from a
    dense projection ``fc`` (init normal(0.01), zero bias) of a per-instance
    embedding ``[B, emb_dim]``."""

    def __init__(self, num_channels: int, emb_dim: int, eps: float = 1e-6,
                 device=None):
        super().__init__(num_channels, device)
        self.eps = eps
        self.fc = Dense(emb_dim, 2 * num_channels, device=device)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        super().reset_parameters(generator)
        if hasattr(self, "fc"):
            with torch.no_grad():
                self.fc.weight.normal_(0.0, 0.01, generator=generator)
                self.fc.bias.zero_()

    def forward(self, x: SparseTensor, emb: torch.Tensor) -> SparseTensor:
        scale, shift = self.fc(emb).chunk(2, dim=-1)
        _, var_b, centered, bid = _instance_moments(x)
        y = centered * broadcast_batch(1.0 / torch.sqrt(var_b + self.eps),
                                       bid, x.valid)
        y = y * self.weight + self.bias
        y = (y * (1.0 + broadcast_batch(scale, bid, x.valid)) +
             broadcast_batch(shift, bid, x.valid))
        return x.with_features(y)


class GroupNormDense(nn.Module):
    """The fork's ``HjmGroupNorm`` on a dense channel-last ``[B, ..., C]``
    array: statistics over the spatial axes and each group's channels, one
    (weight, bias) per group repeated over its channels."""

    def __init__(self, num_channels: int, num_groups: int, eps: float = 1e-6,
                 device=None):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels in {num_groups} "
                             "groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_groups, device=device))
        self.bias = nn.Parameter(torch.zeros(num_groups, device=device))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.num_groups
        xg = x.reshape(*x.shape[:-1], g, x.shape[-1] // g)
        axes = tuple(range(1, x.dim() - 1)) + (x.dim(),)
        mean = xg.mean(dim=axes, keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=axes, keepdim=True)
        y = (xg - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight[:, None] + self.bias[:, None]
        return y.reshape(x.shape)


class HjmInstanceNorm(nn.Module):
    """The fork's ``HjmInstanceNorm``: one BatchNorm applied to each
    instance on its own.  In ``.train()`` each instance's rows are
    normalised with that instance's mean and biased variance (a shared
    affine), and the running statistics take the instances' sequential
    updates in closed form: with decay ``m`` (``momentum``, 0.9: the
    weight of the old value, torch's 0.1 the other way round), present
    instance i weighs ``(1-m)·m^(#present after i)``, the old value
    ``m^#present``, and the running variance takes the unbiased
    ``n/(n-1)`` variance, as ``torch.nn.BatchNorm1d``'s does.  Empty
    instances are skipped.  ``.eval()`` uses the running statistics."""

    def __init__(self, num_channels: int, momentum: float = 0.9,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_channels, device=device))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: SparseTensor) -> SparseTensor:
        if not self.training:
            y = (x.features - self.running_mean) * torch.rsqrt(
                self.running_var + self.eps)
            return x.with_features(y * self.weight + self.bias)
        bid = x.grid.batch_ids()
        mean_b, counts = global_pool(x.features, bid, x.batch_size, x.valid,
                                     "avg")
        centered = ((x.features - broadcast_batch(mean_b, bid, x.valid)) *
                    x.valid[:, None].to(x.features.dtype))
        var_b, _ = global_pool(centered ** 2, bid, x.batch_size, x.valid,
                               "avg")
        y = centered * broadcast_batch(torch.rsqrt(var_b + self.eps), bid,
                                       x.valid)
        with torch.no_grad():
            m = self.momentum
            dt = self.running_mean.dtype
            present = (counts > 0).to(dt)
            after = present.flip(0).cumsum(0).flip(0) - present
            w = (1.0 - m) * torch.pow(m, after) * present
            decay = m ** present.sum()
            bessel = counts.to(dt) / torch.clamp(counts.to(dt) - 1.0, min=1.0)
            self.running_mean.copy_(decay * self.running_mean +
                                    w @ mean_b.detach().to(dt))
            self.running_var.copy_(decay * self.running_var +
                                   w @ (var_b.detach().to(dt) *
                                        bessel[:, None]))
        return x.with_features(y * self.weight + self.bias)
