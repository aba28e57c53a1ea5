"""Sparse latent-diffusion UNet.

Port of `mink_octtree_stablediffusion_tpu/models/unet.py::UNet`: conv_in →
three down groups (2×ResNet3, the first with a stride-2 head) → mid
(2×ResNet3) → three up groups (3×ResNet3, the first with a generative
upsample head, the last pinned to the skip grid) with channel-concat skips
→ conv_out; sinusoidal timestep features → `TimestepEmbedding` feed every
block's instance norm.  Level capacities are clamped to the dense cell
bound of their stride (static Python ints, computed from the input grid's
static extent, stride and batch size — no device reads).

Not ported yet (raise): cross-attention, ``cond_into_time``,
Morton-window attention (``attn_window``) and ``remat``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..nn.blocks import ResNetStack
from ..nn.conv import SparseConv
from ..nn.embed import TimestepEmbedding, timesteps_embedding
from ..nn.init import init_parameters
from ..tensor import SparseTensor, cat
from ..utils.device import make_generator, resolve_device


class UNet(nn.Module):

    def __init__(self, channels: Sequence[int] = (4, 320, 640, 960),
                 out_channels: Optional[int] = None, with_attn: bool = True,
                 attn_max_len: int = 512, attn_window: Optional[int] = None,
                 time_embedding_norm: str = "default", group: int = 1,
                 with_cross_attn: bool = False,
                 cross_attention_dim: int = 768,
                 down_capacities: Sequence[int] = (256, 128, 64),
                 up_capacity_factor: int = 8, remat: bool = False,
                 level0_skip: bool = False, cond_into_time: bool = False,
                 device=None, seed: int = 0):
        super().__init__()
        for flag, name in ((with_cross_attn, "with_cross_attn"),
                           (cond_into_time, "cond_into_time"),
                           (attn_window is not None, "attn_window"),
                           (remat, "remat")):
            if flag:
                raise NotImplementedError(
                    f"UNet {name} is not ported yet (ROADMAP.md queue A)")
        dev = resolve_device(device)
        ch = tuple(channels)
        self.channels = ch
        self.down_capacities = tuple(down_capacities)
        self.up_capacity_factor = up_capacity_factor
        self.level0_skip = level0_skip
        temb = ch[0] * 4
        common = dict(layers=3, use_time_emb=True, temb_channels=temb,
                      time_embedding_norm=time_embedding_norm, group=group,
                      attn_max_len=attn_max_len, device=dev)

        self.time_embedding = TimestepEmbedding(ch[0], temb, device=dev)
        self.conv_in = SparseConv(ch[0], ch[0], kernel_size=3, device=dev)

        def group_of(name, cin, cout, after, n, attn):
            for i in range(n):
                setattr(self, f"{name}_{i}", ResNetStack(
                    cin if i == 0 else cout, cout,
                    after=after if i == 0 else None, with_attn=attn,
                    **common))
            return [getattr(self, f"{name}_{i}") for i in range(n)]

        self._groups = [
            ("block1", group_of("block1", ch[0], ch[1], "downsample", 2,
                                with_attn)),
            ("block2", group_of("block2", ch[1], ch[2], "downsample", 2,
                                with_attn)),
            ("block3", group_of("block3", ch[2], ch[3], "downsample", 2,
                                False)),
            ("res_mid", group_of("res_mid", ch[3], ch[3], None, 2,
                                 with_attn)),
            ("block3_tr", group_of("block3_tr", ch[3], ch[2], "upsample", 3,
                                   False)),
            ("block2_tr", group_of("block2_tr", 2 * ch[2], ch[1], "upsample",
                                   3, with_attn)),
            ("block1_tr", group_of("block1_tr", 2 * ch[1], ch[0], "upsample",
                                   3, with_attn)),
        ]
        self.conv_out = SparseConv(ch[0] * (2 if level0_skip else 1),
                                   out_channels or ch[0], kernel_size=3,
                                   device=dev)
        init_parameters(self, make_generator(seed, dev))
        self.eval()

    def forward(self, x: SparseTensor, timesteps: torch.Tensor,
                encoder_hidden_state: Optional[torch.Tensor] = None
                ) -> SparseTensor:
        """``encoder_hidden_state`` is accepted and unused, as in the JAX
        package without cross-attention or ``cond_into_time``."""
        ch = self.channels
        temb = self.time_embedding(timesteps_embedding(timesteps, ch[0]))

        def cap_bound(level: int) -> Optional[int]:
            if x.grid.extent is None:
                return None
            s = np.asarray(x.grid.stride, np.int64) << level
            cells = int(np.prod([-(-int(e) // int(si))
                                 for e, si in zip(x.grid.extent, s)]))
            return max(x.grid.batch_size * cells, 8)

        def clamp(cap: int, level: int) -> int:
            b = cap_bound(level)
            return cap if b is None else min(cap, -(-b // 128) * 128)

        down_caps = [clamp(c, i + 1)
                     for i, c in enumerate(self.down_capacities)]
        up_caps = [c * self.up_capacity_factor for c in self.down_capacities]
        x = self.conv_in(x)
        h0 = x

        def run(name, h, cap=None, out_grid=None):
            blocks = dict(self._groups)[name]
            for i, blk in enumerate(blocks):
                pin = out_grid if i == len(blocks) - 1 else None
                h = blk(h, temb, out_grid=pin,
                        out_capacity=cap if i == 0 else None)
            return h

        out_s1 = run("block1", x, down_caps[0])
        out_s2 = run("block2", out_s1, down_caps[1])
        out_s3 = run("block3", out_s2, down_caps[2])
        out = run("res_mid", out_s3)
        out = run("block3_tr", out, clamp(up_caps[1], 2), out_s2.grid)
        out = cat(out, out_s2)
        out = run("block2_tr", out, clamp(up_caps[0], 1), out_s1.grid)
        out = cat(out, out_s1)
        out = run("block1_tr", out,
                  clamp(x.capacity * self.up_capacity_factor, 0), x.grid)
        if self.level0_skip:
            out = cat(out, h0)
        return self.conv_out(out)
