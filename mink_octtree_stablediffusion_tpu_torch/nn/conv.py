"""Sparse convolution layers.

Port of `SparseConv`, `SparseConvTranspose`, `GenerativeConvTranspose`,
`UpsampleInterpolate` and `ChannelwiseConv` from
`mink_octtree_stablediffusion_tpu/nn/conv.py`, the convs with the same branch
order: identity (k1 s1) → dense no-growth → brick dense volume (behind
``ops.enable_brick_conv``, off by default, never for CPU tensors; at bf16
compute the brick kernels B5, its dF pass and B6, at float32 their
split-term instantiations B5-f32, dF-f32 and B6-f32) → fused kernel (bounded grids, unless
``ops.use_onehot_conv(False)``) → the opt-in dense route
(``ops.enable_dense_conv``, off by default) → plain gather-GEMM over a kernel map (unbounded grids always: the JAX package
has no kernel for them either).  Kernel
layout is (K, Cin, Cout) with kaiming-normal initialisation over K·Cin.

``record_routes()`` collects, for every conv call, the branch it took, its
shape ``(N_out, Cin, Cout, K)``, whether its input and its kernel get a
gradient and whether it is a rematerialized stack's recompute in the
backward pass (``recomputing``), independently of the kernels' own launch
counters — so a run can check that every fused-route (brick-route) conv
launched the forward kernel and, in training, the dW kernel and (where its
input carries a gradient) the dF kernel, once per conv (once per band of
``ops.fused_conv.offset_bands`` past 125 offsets) and not per recompute.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..ops.conv import (default_compute_dtype, gather_rows, linear_apply,
                        sparse_conv_apply)
from ..ops.coords import SparseGrid, expand_grid, stride_grid
from ..ops.dense_conv import (dense_conv_applicable, dense_conv_apply,
                              dense_conv_general_apply,
                              dense_no_growth_preferred,
                              dense_no_growth_preferred2)
from ..ops.fused_conv import fused_sparse_conv
from ..ops.kernels import KernelSpec, RegionType
from ..ops.onehot_conv import enabled as onehot_enabled
from ..ops.vol_conv import brick_pallas_conv, brick_preferred
from ..ops.neighbors import kernel_map
from ..parallel.tp import copy_to_model, gather_from_model
from ..tensor import SparseTensor


class Route(NamedTuple):
    layer: str  # e.g. "k3s1", "k3s2", "k2s2T" (pinned), "k2s2G" (generative)
    branch: str  # "identity" | "dense" | "brick" | "fused" | "plain"
    n_out: int
    cin: int
    cout: int
    k: int
    # the input features carry a gradient (their conv's backward needs dF)
    grad_in: bool = False
    # the kernel gets a gradient (the conv's backward needs dW); false for
    # a frozen model and under ``torch.no_grad``
    grad_w: bool = False
    # the call recomputes a rematerialized stack's forward in the backward
    # pass: it launches the forward kernel again, and no backward kernel
    recompute: bool = False


_ROUTES: Optional[list] = None
_RECOMPUTE = False


@contextlib.contextmanager
def recomputing(on: bool = True):
    """Mark the conv calls inside the block as a recompute (``Route``)."""
    global _RECOMPUTE
    prev, _RECOMPUTE = _RECOMPUTE, on
    try:
        yield
    finally:
        _RECOMPUTE = prev


@contextlib.contextmanager
def record_routes():
    """Collect the :class:`Route` of every conv call inside the block."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


class _ConvBase(nn.Module):
    """Holds the (K, Cin, Cout) kernel, the optional bias, and the routing
    shared by the three conv layers."""

    tag = ""
    # tensor parallelism (``parallel.shard_model_params``): the parameter
    # a column-parallel layer shards, and its shard once sharded
    tp_weight = "kernel"
    model_shard = None

    def __init__(self, in_channels: int, out_channels: int,
                 spec: KernelSpec, use_bias: bool, dtype, device):
        super().__init__()
        self.spec = spec
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.compute_dtype = dtype  # None -> ops.conv.default_compute_dtype
        self.kernel = nn.Parameter(torch.empty(
            spec.volume, in_channels, out_channels, device=device))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device))
                     if use_bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            std = math.sqrt(2.0 / (self.spec.volume * self.in_channels))
            self.kernel.normal_(0.0, std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def _grad_w(self) -> bool:
        return torch.is_grad_enabled() and self.kernel.requires_grad

    def _layer_name(self) -> str:
        ks, st = self.spec.kernel_size[0], self.spec.stride[0]
        return f"k{ks}s{st}{self.tag}"

    def _conv(self, x: SparseTensor, out_grid: SparseGrid,
              allow_same_grid_dense: bool) -> SparseTensor:
        """Route the conv.  Tensor-parallel (``model_shard``, set by
        ``parallel.shard_model_params``): the same routing on
        ``copy_to_model(x)`` with this rank's ``[K, Cin, Cout/n]`` kernel
        and no bias, then ``gather_from_model`` and the whole bias."""
        spec, cin = self.spec, x.num_channels
        cd = self.compute_dtype or default_compute_dtype(x.features.device)
        tp = self.model_shard
        feats = x.features if tp is None else copy_to_model(x.features, tp)
        bias = self.bias if tp is None else None
        cout = self.kernel.shape[2]  # this rank's slice under tp
        args = (feats, self.kernel)
        if (allow_same_grid_dense and out_grid is x.grid and
                dense_no_growth_preferred(spec, x.grid)):
            branch = "dense"
            out = dense_conv_apply(*args, x.grid, spec, bias,
                                   compute_dtype=cd)
        elif (out_grid is not x.grid and
              dense_no_growth_preferred2(spec, x.grid, out_grid)):
            branch = "dense"
            out = dense_conv_general_apply(*args, x.grid, out_grid, spec,
                                           bias, compute_dtype=cd)
        elif (allow_same_grid_dense and out_grid is x.grid and
              brick_preferred(spec, x.grid, cin, cout, x.features.device)):
            branch = "brick"
            out = brick_pallas_conv(*args, x.grid, compute_dtype=cd)
            if bias is not None:
                out = out + bias
        elif onehot_enabled(x.grid):
            branch = "fused"
            out = fused_sparse_conv(*args, x.grid, out_grid, spec, bias,
                                    compute_dtype=cd)
        elif (allow_same_grid_dense and out_grid is x.grid and
              dense_conv_applicable(spec, x.grid, cin, cout)):
            branch = "dense"
            out = dense_conv_apply(*args, x.grid, spec, bias,
                                   compute_dtype=cd)
        else:
            branch = "plain"
            out = sparse_conv_apply(*args, kernel_map(x.grid, out_grid, spec),
                                    bias, compute_dtype=cd)
        if _ROUTES is not None:
            _ROUTES.append(Route(self._layer_name(), branch, out_grid.capacity,
                                 cin, cout, spec.volume,
                                 x.features.requires_grad, self._grad_w(),
                                 _RECOMPUTE))
        if tp is not None:
            out = gather_from_model(out, tp)
            if self.bias is not None:
                out = out + self.bias
        return SparseTensor(grid=out_grid, features=out).mask_features()


class SparseConv(_ConvBase):
    """Generalized sparse convolution.  ``out_grid`` pins the output
    coordinates; otherwise stride-1 reuses the input grid and stride > 1
    derives the coarsened grid with ``out_capacity`` rows."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride=1, dilation=1, use_bias: bool = False,
                 region_type: RegionType = RegionType.HYPER_CUBE,
                 out_capacity: Optional[int] = None, ndim: int = 3,
                 dtype=None, device=None):
        spec = KernelSpec(kernel_size, stride, dilation, ndim=ndim,
                          region_type=region_type)
        super().__init__(in_channels, out_channels, spec, use_bias, dtype,
                         device)
        self.out_capacity = out_capacity

    def forward(self, x: SparseTensor, out_grid: Optional[SparseGrid] = None,
                out_capacity: Optional[int] = None) -> SparseTensor:
        spec = self.spec
        if spec.is_identity and out_grid is None:
            if _ROUTES is not None:
                _ROUTES.append(Route(self._layer_name(), "identity",
                                     x.capacity, x.num_channels,
                                     self.out_channels, 1,
                                     x.features.requires_grad,
                                     self._grad_w(), _RECOMPUTE))
            return x.with_features(linear_apply(x.features, self.kernel,
                                                self.bias))
        if out_grid is None:
            if all(s == 1 for s in spec.stride):
                out_grid = x.grid
            else:
                out_grid = stride_grid(
                    x.grid, spec.stride,
                    out_capacity or self.out_capacity or x.capacity)
        return self._conv(x, out_grid, allow_same_grid_dense=True)


class SparseConvTranspose(_ConvBase):
    """Upsampling transpose conv pinned to a known finer grid."""

    tag = "T"

    def __init__(self, in_channels: int, out_channels: int, kernel_size=2,
                 stride=2, dilation=1, use_bias: bool = False,
                 region_type: RegionType = RegionType.HYPER_CUBE,
                 ndim: int = 3, dtype=None, device=None):
        spec = KernelSpec(kernel_size, stride, dilation, ndim=ndim,
                          region_type=region_type, transpose=True)
        super().__init__(in_channels, out_channels, spec, use_bias, dtype,
                         device)

    def forward(self, x: SparseTensor, out_grid: SparseGrid) -> SparseTensor:
        return self._conv(x, out_grid, allow_same_grid_dense=False)


class GenerativeConvTranspose(_ConvBase):
    """Octree growth: output coordinates = union of input coords ⊕ kernel
    offsets at the finer stride, in a buffer of ``out_capacity`` rows."""

    tag = "G"

    def __init__(self, in_channels: int, out_channels: int,
                 out_capacity: Optional[int] = None, kernel_size=2, stride=2,
                 dilation=1, use_bias: bool = False, ndim: int = 3,
                 dtype=None, device=None):
        spec = KernelSpec(kernel_size, stride, dilation, ndim=ndim,
                          transpose=True)
        super().__init__(in_channels, out_channels, spec, use_bias, dtype,
                         device)
        self.out_capacity = out_capacity

    def forward(self, x: SparseTensor,
                out_capacity: Optional[int] = None) -> SparseTensor:
        cap = out_capacity or self.out_capacity
        assert cap is not None, "GenerativeConvTranspose needs out_capacity"
        out_grid = expand_grid(x.grid,
                               self.spec.absolute_offsets(x.tensor_stride),
                               self.spec.out_stride(x.tensor_stride), cap)
        return self._conv(x, out_grid, allow_same_grid_dense=False)


class UpsampleInterpolate(nn.Module):
    """Exact nearest-neighbour octree upsample, parameter-free: the
    generative k2-s2 transpose's output grid in ``out_capacity`` rows,
    where every child voxel copies its parent's features (each output row
    has exactly one parent among the K offsets, so the sum of the
    per-offset gathers is that parent's row)."""

    def __init__(self, out_capacity: int, kernel_size=2, stride=2,
                 ndim: int = 3):
        super().__init__()
        self.spec = KernelSpec(kernel_size, stride, ndim=ndim,
                               transpose=True)
        self.out_capacity = out_capacity

    def forward(self, x: SparseTensor,
                out_capacity: Optional[int] = None) -> SparseTensor:
        spec = self.spec
        out_grid = expand_grid(x.grid, spec.absolute_offsets(x.tensor_stride),
                               spec.out_stride(x.tensor_stride),
                               out_capacity or self.out_capacity)
        out = 0.0
        for ix in kernel_map(x.grid, out_grid, spec):
            out = out + gather_rows(x.features, ix)
        return SparseTensor(grid=out_grid, features=out).mask_features()


class ChannelwiseConv(nn.Module):
    """Depthwise sparse conv (the reference's
    ``MinkowskiChannelwiseConvolution``): ``out[j] = Σ_k in[nbr_k(j)] ·
    w_k`` with a per-channel kernel ``[K, C]`` (kaiming normal over K),
    over a kernel map on any grid.  The kernel keeps the flax layout, so
    ``utils.convert`` copies it as it is."""

    def __init__(self, channels: int, kernel_size=3, stride=1, dilation=1,
                 use_bias: bool = False,
                 region_type: RegionType = RegionType.HYPER_CUBE,
                 out_capacity: Optional[int] = None, ndim: int = 3,
                 device=None):
        super().__init__()
        self.spec = KernelSpec(kernel_size, stride, dilation, ndim=ndim,
                               region_type=region_type)
        self.out_capacity = out_capacity
        self.kernel = nn.Parameter(torch.empty(self.spec.volume, channels,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(channels, device=device))
                     if use_bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.kernel.normal_(0.0, math.sqrt(2.0 / self.spec.volume),
                                generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: SparseTensor,
                out_grid: Optional[SparseGrid] = None) -> SparseTensor:
        spec = self.spec
        if out_grid is None:
            out_grid = x.grid if all(s == 1 for s in spec.stride) else \
                stride_grid(x.grid, spec.stride,
                            self.out_capacity or x.capacity)
        out = 0.0
        for k, ix in enumerate(kernel_map(x.grid, out_grid, spec)):
            out = out + gather_rows(x.features, ix) * self.kernel[k]
        if self.bias is not None:
            out = out + self.bias
        return SparseTensor(grid=out_grid, features=out).mask_features()
