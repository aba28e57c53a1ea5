"""Residual blocks over sparse tensors.

Port of `_Norm`, `BasicBlock`, `_HeadConvNormAct` and `ResNetStack` from
`mink_octtree_stablediffusion_tpu/nn/blocks.py`, conv heads only (the
avg-pool, pool-transpose and interpolate heads are not ported yet).
Submodule names follow the flax tree (``head``/``blockJ``/``tail``,
``conv1``/``norm1``/…), so `utils.convert.from_flax` maps one onto the
other by name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.coords import SparseGrid
from ..tensor import SparseTensor
from .act import get_act
from .attention import SparseTransformer
from .conv import GenerativeConvTranspose, SparseConv, SparseConvTranspose
from .linear import Dense
from .norm import BatchNorm, StableInstanceNorm
from .pool import broadcast_op


class _Norm(nn.Module):
    """BatchNorm (``bn``) or group-averaged instance norm (``inorm``)."""

    def __init__(self, kind: str, channels: int, group: int = 1,
                 device=None):
        super().__init__()
        if kind == "batch":
            self.bn = BatchNorm(channels, device=device)
        else:
            self.inorm = StableInstanceNorm(channels, group, device=device)

    def forward(self, x: SparseTensor) -> SparseTensor:
        return self.bn(x) if hasattr(self, "bn") else self.inorm(x)


class BasicBlock(nn.Module):
    """conv3 → norm (+ time-embedding add or FiLM) → act → conv3 → norm →
    + residual → optional self-attention → act.  ``prenorm`` moves each
    norm before its conv."""

    def __init__(self, channels: int, use_time_emb: bool = False,
                 temb_channels: Optional[int] = None,
                 time_embedding_norm: str = "default", group: int = 1,
                 with_attn: bool = False, attn_max_len: int = 256,
                 with_cross_attn: bool = False, attn_window=None,
                 act_fn: str = "elu", prenorm: bool = False, device=None):
        super().__init__()
        if with_cross_attn:
            raise NotImplementedError(
                "cross-attention is not ported yet (ROADMAP.md queue A)")
        if with_attn and attn_window is not None:
            raise NotImplementedError(
                "Morton-window attention is not ported yet (ROADMAP.md "
                "queue A)")
        p = channels
        kind = "instance" if use_time_emb else "batch"
        self.act = get_act("silu" if prenorm and act_fn == "elu" else act_fn)
        self.prenorm = prenorm
        self.use_time_emb = use_time_emb
        self.time_embedding_norm = time_embedding_norm
        self.conv1 = SparseConv(p, p, kernel_size=3, device=device)
        self.norm1 = _Norm(kind, p, group, device=device)
        self.conv2 = SparseConv(p, p, kernel_size=3, device=device)
        self.norm2 = _Norm(kind, p, group, device=device)
        if use_time_emb:
            width = p if time_embedding_norm == "default" else 2 * p
            self.time_emb_proj = Dense(temb_channels, width, device=device)
        self.attentions = (SparseTransformer(p, attn_max_len, device=device)
                           if with_attn else None)

    def forward(self, x: SparseTensor,
                emb: Optional[torch.Tensor] = None) -> SparseTensor:
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
            out = self.attentions(out)
        return out.with_features(self.act(out.features))


class _HeadConvNormAct(nn.Module):
    """conv (down / generative up / pinned up / adapt) + norm + act."""

    def __init__(self, in_channels: int, channels: int, mode: str,
                 norm_kind: str = "batch", group: int = 1,
                 out_capacity: Optional[int] = None, act_fn: str = "elu",
                 device=None):
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
        self.norm = _Norm(norm_kind, channels, group, device=device)
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
    pinned to ``out_grid``."""

    def __init__(self, in_channels: int, out_channels: int, layers: int = 2,
                 after: Optional[str] = None, use_conv: bool = True,
                 use_time_emb: bool = False,
                 temb_channels: Optional[int] = None,
                 time_embedding_norm: str = "default", group: int = 1,
                 with_attn: bool = False, attn_max_len: int = 256,
                 with_cross_attn: bool = False, attn_window=None,
                 out_capacity: Optional[int] = None, act_fn: str = "elu",
                 device=None):
        super().__init__()
        if not use_conv or after not in (None, "downsample", "upsample",
                                         "upsample_determine"):
            raise NotImplementedError(
                f"ResNetStack head after={after!r} use_conv={use_conv} "
                "(pool / interpolate heads) is not ported yet")
        self.after = after
        self.out_capacity = out_capacity
        norm_kind = "instance" if use_time_emb else "batch"
        mode = {"downsample": "down", "upsample": "up",
                "upsample_determine": "up_determine"}.get(after, "adapt")
        self.head = _HeadConvNormAct(in_channels, out_channels, mode,
                                     norm_kind, group, out_capacity, act_fn,
                                     device=device)
        self.num_blocks = layers - 1
        for i in range(1, layers):
            setattr(self, f"block{i}", BasicBlock(
                out_channels, use_time_emb=use_time_emb,
                temb_channels=temb_channels,
                time_embedding_norm=time_embedding_norm, group=group,
                with_attn=with_attn, attn_max_len=attn_max_len,
                with_cross_attn=with_cross_attn, attn_window=attn_window,
                act_fn=act_fn, device=device))
        self.tail = (_HeadConvNormAct(out_channels, out_channels, "adapt",
                                      norm_kind, group, None, act_fn,
                                      device=device)
                     if use_time_emb else None)

    def forward(self, x: SparseTensor, emb: Optional[torch.Tensor] = None,
                out_grid: Optional[SparseGrid] = None,
                out_capacity: Optional[int] = None) -> SparseTensor:
        has_tail = self.tail is not None
        # a pinned-transpose head always receives the target grid; without
        # a tail the head carries the pin (except a generative head)
        if self.after == "upsample_determine":
            head_grid = out_grid
        elif not has_tail and self.after != "upsample":
            head_grid = out_grid
        else:
            head_grid = None
        x = self.head(x, out_grid=head_grid,
                      out_capacity=out_capacity or self.out_capacity)
        for i in range(1, self.num_blocks + 1):
            x = getattr(self, f"block{i}")(x, emb)
        if has_tail:
            x = self.tail(x, out_grid=out_grid)
        return x
