"""Residual blocks over sparse tensors.

Port of `_Norm`, `BasicBlock`, `_HeadConvNormAct`, `ResNetStack` (its
conv heads and its avg-pool, pool-transpose and interpolate geometry
heads), `remat_stack` (as ``remat_call``) and the classic
`ResBasicBlock`, `ResBottleneck`, `SELayer`, `SEBasicBlock` and
`SEBottleneck` from `mink_octtree_stablediffusion_tpu/nn/blocks.py` (its
`_per_instance_cells` lives in `nn/attention.py` here).  A
``process_group`` makes every BatchNorm of a block SyncBN, where JAX
threads ``axis_name``.  Submodule names follow the flax tree
(``head``/``blockJ``/``tail``, ``conv1``/``norm1``/…), so
`utils.convert.from_flax` maps one onto the other by name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.coords import SparseGrid
from ..tensor import SparseTensor
from .act import get_act
from .attention import (SparseTransformer, _per_instance_cells,
                        morton_window_attention)
from .conv import (GenerativeConvTranspose, SparseConv, SparseConvTranspose,
                   UpsampleInterpolate, recomputing)
from .linear import Dense
from .norm import BatchNorm, StableInstanceNorm
from .pool import LocalPool, PoolTranspose, broadcast_op, global_pool_features


class _Norm(nn.Module):
    """BatchNorm (``bn``) or group-averaged instance norm (``inorm``)."""

    def __init__(self, kind: str, channels: int, group: int = 1,
                 process_group=None, device=None):
        super().__init__()
        if kind == "batch":
            self.bn = BatchNorm(channels, process_group=process_group,
                                device=device)
        else:
            self.inorm = StableInstanceNorm(channels, group, device=device)

    def forward(self, x: SparseTensor) -> SparseTensor:
        return self.bn(x) if hasattr(self, "bn") else self.inorm(x)


class BasicBlock(nn.Module):
    """conv3 → norm (+ time-embedding add or FiLM) → act → conv3 → norm →
    + residual → optional self-attention → optional cross-attention →
    act.  ``prenorm`` moves each norm before its conv.

    With ``attn_window``, a grid whose per-instance cell bound exceeds
    ``attn_max_len`` takes Morton-window self-attention and any other
    grid full attention, chosen at each call; both use the projections
    of ``attentions.attn``.  Cross-attention (``with_cross_attn``, only
    with ``with_attn``) stays full: its keys are the condition's few
    tokens."""

    def __init__(self, channels: int, use_time_emb: bool = False,
                 temb_channels: Optional[int] = None,
                 time_embedding_norm: str = "default", group: int = 1,
                 with_attn: bool = False, attn_max_len: int = 256,
                 with_cross_attn: bool = False,
                 cross_attention_dim: int = 768,
                 attn_window: Optional[int] = None, act_fn: str = "elu",
                 prenorm: bool = False, process_group=None, device=None):
        super().__init__()
        p = channels
        kind = "instance" if use_time_emb else "batch"
        self.act = get_act("silu" if prenorm and act_fn == "elu" else act_fn)
        self.prenorm = prenorm
        self.use_time_emb = use_time_emb
        self.time_embedding_norm = time_embedding_norm
        self.conv1 = SparseConv(p, p, kernel_size=3, device=device)
        self.norm1 = _Norm(kind, p, group, process_group, device=device)
        self.conv2 = SparseConv(p, p, kernel_size=3, device=device)
        self.norm2 = _Norm(kind, p, group, process_group, device=device)
        if use_time_emb:
            width = p if time_embedding_norm == "default" else 2 * p
            self.time_emb_proj = Dense(temb_channels, width, device=device)
        self.attn_max_len = attn_max_len
        self.attn_window = attn_window
        self.attentions = (SparseTransformer(p, attn_max_len, device=device)
                           if with_attn else None)
        self.cross_attention = (
            SparseTransformer(p, attn_max_len,
                              cross_attention_dim=cross_attention_dim,
                              device=device)
            if with_attn and with_cross_attn else None)

    def forward(self, x: SparseTensor, emb: Optional[torch.Tensor] = None,
                encoder_hidden_state: Optional[torch.Tensor] = None
                ) -> SparseTensor:
        p = self.conv1.out_channels
        if self.prenorm:
            out = self.conv1(self.norm1(x))
        else:
            out = self.norm1(self.conv1(x))
        if self.use_time_emb:
            assert emb is not None
            e = self.time_emb_proj(F.elu(emb))
            if self.time_embedding_norm == "default":
                out = broadcast_op(out, e, "add")
            else:  # scale_shift FiLM: out*(1+scale)+shift
                out = broadcast_op(out, 1.0 + e[:, :p], "mul")
                out = broadcast_op(out, e[:, p:], "add")
        out = out.with_features(self.act(out.features))
        if self.prenorm:
            out = self.conv2(self.norm2(out))
        else:
            out = self.norm2(self.conv2(out))
        out = out + x
        if self.attentions is not None:
            out = out.with_features(self.act(out.features))
            if (self.attn_window is not None and
                    _per_instance_cells(out.grid) > self.attn_max_len):
                out = morton_window_attention(out, self.attentions.attn,
                                              self.attn_window)
            else:
                out = self.attentions(out)
            if self.cross_attention is not None:
                out = out.with_features(self.act(out.features))
                out = self.cross_attention(out, encoder_hidden_state)
        return out.with_features(self.act(out.features))


class _HeadConvNormAct(nn.Module):
    """conv (down / generative up / pinned up / adapt) + norm + act."""

    def __init__(self, in_channels: int, channels: int, mode: str,
                 norm_kind: str = "batch", group: int = 1,
                 out_capacity: Optional[int] = None, act_fn: str = "elu",
                 process_group=None, device=None):
        super().__init__()
        self.mode = mode
        if mode == "down":
            self.conv = SparseConv(in_channels, channels, kernel_size=3,
                                   stride=2, out_capacity=out_capacity,
                                   device=device)
        elif mode == "up":
            self.conv = GenerativeConvTranspose(
                in_channels, channels, out_capacity=out_capacity,
                kernel_size=2, stride=2, device=device)
        elif mode == "up_determine":
            self.conv = SparseConvTranspose(in_channels, channels,
                                            kernel_size=2, stride=2,
                                            device=device)
        else:  # adapt
            self.conv = SparseConv(in_channels, channels, kernel_size=3,
                                   device=device)
        self.norm = _Norm(norm_kind, channels, group, process_group,
                          device=device)
        self.act = get_act(act_fn)

    def forward(self, x: SparseTensor, out_grid: Optional[SparseGrid] = None,
                out_capacity: Optional[int] = None) -> SparseTensor:
        if self.mode == "down":
            out = self.conv(x, out_grid=out_grid, out_capacity=out_capacity)
        elif self.mode == "up":
            out = self.conv(x, out_capacity=out_capacity)
        elif self.mode == "up_determine":
            assert out_grid is not None
            out = self.conv(x, out_grid)
        else:
            out = self.conv(x, out_grid=out_grid)
        out = self.norm(out)
        return out.with_features(self.act(out.features))


class ResNetStack(nn.Module):
    """A geometry head followed by ``layers - 1`` BasicBlocks, plus a
    trailing adapt (``tail``) when time-conditioned; the last layer can be
    pinned to ``out_grid``.

    ``after`` is None (adapt), ``"downsample"``, ``"upsample"`` or
    ``"upsample_determine"`` (conv heads), or ``"avg_pool"``,
    ``"pool_transpose"`` or ``"upsample_interpolate"``: an adapt head,
    the blocks, then that parameter-free geometry op (``pool``,
    ``pool_tr``, ``up_interp``).  ``use_conv=False`` turns the down/up
    conv heads into avg-pool / interpolate, as the reference's flag."""

    GEOMETRY_OPS = ("avg_pool", "pool_transpose", "upsample_interpolate")

    def __init__(self, in_channels: int, out_channels: int, layers: int = 2,
                 after: Optional[str] = None, use_conv: bool = True,
                 use_time_emb: bool = False,
                 temb_channels: Optional[int] = None,
                 time_embedding_norm: str = "default", group: int = 1,
                 with_attn: bool = False, attn_max_len: int = 256,
                 with_cross_attn: bool = False,
                 cross_attention_dim: int = 768,
                 attn_window: Optional[int] = None,
                 out_capacity: Optional[int] = None, act_fn: str = "elu",
                 process_group=None, device=None):
        super().__init__()
        geom_op = after if after in self.GEOMETRY_OPS else None
        if not use_conv:
            geom_op = {"downsample": "avg_pool",
                       "upsample": "upsample_interpolate",
                       "upsample_determine": "upsample_interpolate",
                       }.get(after, geom_op)
        if geom_op is None and after not in (None, "downsample", "upsample",
                                             "upsample_determine"):
            raise ValueError(f"ResNetStack after={after!r}")
        self.after = after
        self.geom_op = geom_op
        # only a conv head carries the geometry (and can take a pin)
        self.conv_head = use_conv and geom_op is None
        self.out_capacity = out_capacity
        norm_kind = "instance" if use_time_emb else "batch"
        mode = ({"downsample": "down", "upsample": "up",
                 "upsample_determine": "up_determine"}.get(after, "adapt")
                if self.conv_head else "adapt")
        self.head = _HeadConvNormAct(in_channels, out_channels, mode,
                                     norm_kind, group, out_capacity, act_fn,
                                     process_group, device=device)
        self.num_blocks = layers - 1
        for i in range(1, layers):
            setattr(self, f"block{i}", BasicBlock(
                out_channels, use_time_emb=use_time_emb,
                temb_channels=temb_channels,
                time_embedding_norm=time_embedding_norm, group=group,
                with_attn=with_attn, attn_max_len=attn_max_len,
                with_cross_attn=with_cross_attn,
                cross_attention_dim=cross_attention_dim,
                attn_window=attn_window, act_fn=act_fn,
                process_group=process_group, device=device))
        if geom_op == "avg_pool":
            self.pool = LocalPool(2, 2, mode="avg")
        elif geom_op == "pool_transpose":
            self.pool_tr = PoolTranspose(2, 2)
        elif geom_op == "upsample_interpolate":
            if out_capacity is None:
                raise ValueError("after='upsample_interpolate' needs "
                                 "out_capacity")
            self.up_interp = UpsampleInterpolate(out_capacity)
        self.tail = (_HeadConvNormAct(out_channels, out_channels, "adapt",
                                      norm_kind, group, None, act_fn,
                                      process_group, device=device)
                     if use_time_emb else None)

    def forward(self, x: SparseTensor, emb: Optional[torch.Tensor] = None,
                out_grid: Optional[SparseGrid] = None,
                out_capacity: Optional[int] = None,
                encoder_hidden_state: Optional[torch.Tensor] = None
                ) -> SparseTensor:
        has_tail = self.tail is not None
        cap = out_capacity or self.out_capacity
        # a pinned-transpose head always receives the target grid; without
        # a tail a conv head carries the pin (except a generative head);
        # behind a geometry op, or with no conv head, the op or the tail does
        if not self.conv_head:
            x = self.head(x)
        else:
            if self.after == "upsample_determine":
                head_grid = out_grid
            elif not has_tail and self.after != "upsample":
                head_grid = out_grid
            else:
                head_grid = None
            x = self.head(x, out_grid=head_grid, out_capacity=cap)
        for i in range(1, self.num_blocks + 1):
            x = getattr(self, f"block{i}")(x, emb, encoder_hidden_state)
        if self.geom_op == "avg_pool":
            x = self.pool(x, out_grid=None if has_tail else out_grid,
                          out_capacity=cap)
        elif self.geom_op == "pool_transpose":
            if out_grid is None:
                raise ValueError("after='pool_transpose' needs the finer "
                                 "target grid")
            x = self.pool_tr(x, out_grid)
        elif self.geom_op == "upsample_interpolate":
            x = self.up_interp(x, out_capacity=cap)
        if has_tail:
            x = self.tail(x, out_grid=out_grid)
        return x


def remat_call(stack: nn.Module, x: SparseTensor, *args, **kw):
    """``stack(x, *args, **kw)`` with its activations rematerialized in the
    backward pass (``torch.utils.checkpoint``, non-reentrant; JAX's
    `remat_stack`): only the inputs are kept, and the forward runs again
    when the backward reaches it.  The returned object is the first
    forward's, so a pinned output grid keeps its identity.  The recompute
    restores the global RNG state but not a ``torch.Generator`` passed
    in, so nothing inside ``stack`` may draw from one.  Its conv calls are
    marked as a recompute (``nn.conv.recomputing``)."""
    calls = 0

    def run(x, *args):
        nonlocal calls
        calls += 1
        with recomputing(calls > 1):
            return stack(x, *args, **kw)

    return checkpoint(run, x, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Classic ResNet / SENet blocks
# ---------------------------------------------------------------------------


def _relu(x: SparseTensor) -> SparseTensor:
    return x.with_features(F.relu(x.features))


class ResBasicBlock(nn.Module):
    """conv3 (stride) → bn → relu → conv3 → bn (→ squeeze-excite ``se``,
    in the SE blocks) + residual (a 1x1 conv + bn pinned to the output
    grid when the stride or the width changes) → relu."""

    expansion = 1
    with_se = False

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, out_capacity: Optional[int] = None,
                 reduction: int = 16, process_group=None, device=None):
        super().__init__()
        out = planes * self.expansion
        self._layers(in_channels, planes, stride, dilation, out_capacity,
                     process_group, device)
        if self.with_se:
            self.se = SELayer(out, reduction, device=device)
        self.has_downsample = stride != 1 or in_channels != out
        if self.has_downsample:
            self.downsample_conv = SparseConv(in_channels, out, 1,
                                              device=device)
            self.downsample_norm = BatchNorm(out, process_group=process_group,
                                             device=device)

    def _layers(self, cin, planes, stride, dilation, cap, pg, device):
        self.conv1 = SparseConv(cin, planes, 3, stride, dilation,
                                out_capacity=cap, device=device)
        self.norm1 = BatchNorm(planes, process_group=pg, device=device)
        self.conv2 = SparseConv(planes, planes, 3, 1, dilation,
                                device=device)
        self.norm2 = BatchNorm(planes, process_group=pg, device=device)

    def body(self, x: SparseTensor) -> SparseTensor:
        out = _relu(self.norm1(self.conv1(x)))
        return self.norm2(self.conv2(out))

    def forward(self, x: SparseTensor) -> SparseTensor:
        out = self.body(x)
        if self.with_se:
            out = self.se(out)
        res = (self.downsample_norm(self.downsample_conv(
            x, out_grid=out.grid)) if self.has_downsample else x)
        return _relu(out + res)


class ResBottleneck(ResBasicBlock):
    """conv1 → bn → relu → conv3 (stride) → bn → relu → conv1 (×4 width) →
    bn (→ squeeze-excite) + residual → relu."""

    expansion = 4

    def _layers(self, cin, planes, stride, dilation, cap, pg, device):
        self.conv1 = SparseConv(cin, planes, 1, device=device)
        self.norm1 = BatchNorm(planes, process_group=pg, device=device)
        self.conv2 = SparseConv(planes, planes, 3, stride, dilation,
                                out_capacity=cap, device=device)
        self.norm2 = BatchNorm(planes, process_group=pg, device=device)
        self.conv3 = SparseConv(planes, planes * 4, 1, device=device)
        self.norm3 = BatchNorm(planes * 4, process_group=pg, device=device)

    def body(self, x: SparseTensor) -> SparseTensor:
        out = _relu(self.norm1(self.conv1(x)))
        out = _relu(self.norm2(self.conv2(out)))
        return self.norm3(self.conv3(out))


class SELayer(nn.Module):
    """Squeeze-excite: global average pool → fc (C → C/reduction) → relu →
    fc → sigmoid → multiply every voxel row by its instance's gate."""

    def __init__(self, channels: int, reduction: int = 16, device=None):
        super().__init__()
        self.fc1 = Dense(channels, channels // reduction, device=device)
        self.fc2 = Dense(channels // reduction, channels, device=device)

    def forward(self, x: SparseTensor) -> SparseTensor:
        g = F.relu(self.fc1(global_pool_features(x, "avg")))
        return broadcast_op(x, torch.sigmoid(self.fc2(g)), "mul")


class SEBasicBlock(ResBasicBlock):
    with_se = True


class SEBottleneck(ResBottleneck):
    with_se = True
