"""Octree sparse VAE: residual encoder + pruning/growing decoder.

Port of `Encoder`, `Decoder`, `VAE` and `vae_loss` from
`mink_octtree_stablediffusion_tpu/models/vae.py`.  Encoder = three
stride-2 ResNet2 stages + two same-stride stages + mean/log-var conv heads
(stride-8 latent).  Decoder = one same-stride ResNet2 then three
generative-upsample ResNet2 stages, each followed by a 1x1 occupancy head,
a membership test against the strided target set, a top-k capacity clamp
and pruning; in ``.train()`` the target voxels of levels 0–2 are
force-kept so that deeper levels always receive supervision.  A new `VAE`
is in ``.eval()`` (BatchNorm on running statistics, as generation needs);
a trainer calls ``.train()``.

``Encoder.with_window_attn`` adds a Morton-window transformer after
``block3``.  ``VAE.latent_canvas`` scatters the sampled latent onto the
full dense stride-8 canvas before decoding (`ops/canvas.py`), with
N(0, ``canvas_noise_std``²) features at the empty cells in ``.train()``,
so that diffusion can sample from pure noise on a grid that depends on
no data.  ``process_group`` makes every BatchNorm SyncBN (JAX's
``axis_name``), for the data-parallel step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..nn.attention import MortonWindowTransformer
from ..nn.blocks import ResNetStack
from ..nn.conv import SparseConv
from ..nn.init import init_parameters
from ..ops.canvas import canvas_grid, expand_to_canvas
from ..ops.coords import SparseGrid, stride_grid
from ..ops.neighbors import membership
from ..ops.pruning import prune, top_k_mask
from ..tensor import SparseTensor
from ..utils.device import make_generator, resolve_device


class Encoder(nn.Module):

    def __init__(self, channels: Sequence[int] = (32, 128, 512, 512, 4),
                 level_capacities: Sequence[int] = (16384, 8192, 2048, 2048,
                                                    2048),
                 in_channels: int = 1, with_window_attn: bool = False,
                 window_size: int = 50, process_group=None, device=None):
        super().__init__()
        ch, caps = tuple(channels), tuple(level_capacities)
        pg = process_group
        self.block1 = ResNetStack(in_channels, ch[0], after="downsample",
                                  out_capacity=caps[0], process_group=pg,
                                  device=device)
        self.block2 = ResNetStack(ch[0], ch[1], after="downsample",
                                  out_capacity=caps[1], process_group=pg,
                                  device=device)
        self.block3 = ResNetStack(ch[1], ch[2], after="downsample",
                                  out_capacity=caps[2], process_group=pg,
                                  device=device)
        self.window_attn = (MortonWindowTransformer(ch[2], window_size,
                                                    device=device)
                            if with_window_attn else None)
        self.block4 = ResNetStack(ch[2], ch[3], process_group=pg,
                                  device=device)
        self.block5 = ResNetStack(ch[3], ch[4], process_group=pg,
                                  device=device)
        self.mean_conv = SparseConv(ch[4], ch[4], kernel_size=3, device=device)
        self.log_var_conv = SparseConv(ch[4], ch[4], kernel_size=3,
                                       device=device)

    def trunk(self, x: SparseTensor) -> SparseTensor:
        """The five stages, before the two heads."""
        for blk in (self.block1, self.block2, self.block3):
            x = blk(x)
        if self.window_attn is not None:
            x = self.window_attn(x)
        for blk in (self.block4, self.block5):
            x = blk(x)
        return x

    def forward(self, x: SparseTensor):
        x = self.trunk(x)
        return self.mean_conv(x), self.log_var_conv(x)


class Decoder(nn.Module):
    """``channels`` are the encoder's reversed, e.g. (4, 512, 512, 128, 32);
    ``level_capacities`` the candidate-set buffer of each level, coarse to
    fine."""

    def __init__(self, channels: Sequence[int] = (4, 512, 512, 128, 32),
                 level_capacities: Sequence[int] = (2048, 8192, 16384, 32768),
                 max_keep: Optional[int] = None, process_group=None,
                 device=None):
        super().__init__()
        ch = tuple(channels)
        self.level_capacities = tuple(level_capacities)
        self.max_keep = max_keep
        for lvl in range(4):
            setattr(self, f"block{lvl + 1}", ResNetStack(
                ch[lvl], ch[lvl + 1], after=None if lvl == 0 else "upsample",
                out_capacity=self.level_capacities[lvl],
                process_group=process_group, device=device))
            setattr(self, f"block{lvl + 1}_cls", SparseConv(
                ch[lvl + 1], 1, kernel_size=1, use_bias=True, device=device))

    def forward(self, z: SparseTensor, target_grid: SparseGrid):
        """→ (per-level logits tensors, per-level membership targets, the
        decoded stride-1 tensor)."""
        out = z
        out_clss, targets = [], []
        for lvl in range(4):
            out = getattr(self, f"block{lvl + 1}")(out)
            logits_t = getattr(self, f"block{lvl + 1}_cls")(out)
            strided_target = stride_grid(target_grid, tuple(out.tensor_stride),
                                         capacity=self.level_capacities[lvl])
            out_clss.append(logits_t)
            targets.append(membership(out.grid, strided_target))
            keep = top_k_mask(logits_t.features[:, 0], out.valid,
                              self.max_keep or
                              self.level_capacities[min(lvl + 1, 3)])
            if self.training and lvl < 3:
                keep = keep | targets[-1]
            grid, feats = prune(out.grid, out.features, keep)
            out = SparseTensor(grid=grid, features=feats)
        return out_clss, targets, out


class VAE(nn.Module):

    def __init__(self, channels: Sequence[int] = (32, 128, 512, 512, 4),
                 encoder_capacities: Sequence[int] = (16384, 8192, 2048, 2048,
                                                      2048),
                 decoder_capacities: Sequence[int] = (2048, 8192, 16384,
                                                      32768),
                 max_keep: Optional[int] = None, in_channels: int = 1,
                 with_window_attn: bool = False, window_size: int = 50,
                 latent_canvas: bool = False, canvas_noise_std: float = 1.0,
                 process_group=None, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.decoder_capacities = tuple(decoder_capacities)
        self.latent_canvas = latent_canvas
        self.canvas_noise_std = canvas_noise_std
        self.encoder = Encoder(channels, encoder_capacities, in_channels,
                               with_window_attn, window_size, process_group,
                               device=dev)
        self.decoder = Decoder(tuple(reversed(tuple(channels))),
                               decoder_capacities, max_keep, process_group,
                               device=dev)
        init_parameters(self, make_generator(seed, dev))
        self.eval()

    def to_canvas(self, z: SparseTensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> SparseTensor:
        """Scatter a sparse latent onto the full dense canvas at its
        stride; the empty cells get N(0, ``canvas_noise_std``²) from
        ``noise`` (N(0,1) draws, one row per canvas cell) or ``generator``
        where either is given, else zeros.  The decoder's
        level-0 buffer must hold every canvas cell (a smaller one would
        truncate the level-0 membership target)."""
        if z.grid.extent is None:
            raise ValueError(
                "latent_canvas needs a bounded input grid (extent=...)")
        cells = z.batch_size * int(np.prod(
            [-(-e // s) for e, s in zip(z.grid.extent, z.grid.stride)]))
        if self.decoder_capacities[0] < cells:
            raise ValueError(
                f"latent_canvas needs decoder_capacities[0] >= batch*canvas "
                f"cells ({cells}); got {self.decoder_capacities[0]}")
        canvas = canvas_grid(z.batch_size, z.grid.extent, z.grid.stride,
                             z.grid.ndim, device=z.features.device)
        noisy = generator is not None or noise is not None
        return expand_to_canvas(z, canvas,
                                self.canvas_noise_std if noisy else 0.0,
                                generator=generator, noise=noise)

    def encode(self, sinput: SparseTensor):
        return self.encoder(sinput)

    def decode(self, z: SparseTensor, target_grid: SparseGrid):
        return self.decoder(z, target_grid)

    def forward(self, sinput: SparseTensor, target_grid: SparseGrid,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                canvas_noise: Optional[torch.Tensor] = None):
        """encode → reparameterize → (canvas) → decode.  ``eps`` is the
        N(0,1) noise of the reparameterisation, shaped like the latent's
        features; when it is not given it is drawn from ``generator``.
        With ``latent_canvas``, ``z`` is scattered onto the canvas, whose
        empty cells get noise in ``.train()``: ``canvas_noise`` (N(0,1),
        one row per canvas cell) where given, else a draw from
        ``generator``.  Returns (out_clss, targets, sout, mean, log_var,
        z)."""
        mean, log_var = self.encode(sinput)
        if eps is None:
            eps = torch.randn(log_var.features.shape, generator=generator,
                              device=log_var.features.device)
        z = mean.with_features(mean.features +
                               torch.exp(0.5 * log_var.features) * eps)
        if self.latent_canvas:
            if self.training and generator is None and canvas_noise is None:
                raise ValueError("latent_canvas in .train() draws the canvas "
                                 "noise from a generator")
            z = (self.to_canvas(z, generator, canvas_noise) if self.training
                 else self.to_canvas(z))
        out_clss, targets, sout = self.decode(z, target_grid)
        return out_clss, targets, sout, mean, log_var, z


def occupancy_bce(out_clss, targets) -> torch.Tensor:
    """The per-level masked BCE-with-logits of the occupancy heads against
    their membership targets, averaged over the levels."""
    bce = 0.0
    for logits_t, target in zip(out_clss, targets):
        lo = logits_t.features[:, 0]
        v = logits_t.valid
        t = target.to(lo.dtype)
        per = lo.clamp(min=0.0) - lo * t + torch.log1p(torch.exp(-lo.abs()))
        bce = bce + torch.where(v, per, 0.0).sum() / v.to(lo.dtype).sum(
        ).clamp(min=1.0)
    return bce / float(len(out_clss))


def vae_loss(out_clss, targets, mean: SparseTensor, log_var: SparseTensor,
             kld_weight: float = 1e-6):
    """Per-level masked BCE-with-logits averaged over levels + KLD over the
    valid latent rows → (loss, {"bce", "kld"})."""
    bce = occupancy_bce(out_clss, targets)
    vmask = mean.valid[:, None].to(mean.features.dtype)
    kld = -0.5 * ((1 + log_var.features - mean.features ** 2 -
                   torch.exp(log_var.features)) * vmask).sum() / (
        vmask.sum().clamp(min=1.0))
    return bce + kld_weight * kld, {"bce": bce, "kld": kld}
