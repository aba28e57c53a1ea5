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

Not ported yet (raise): the Morton-window attention of the encoder and the
dense latent canvas (``latent_canvas``, `ops/canvas.py`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.blocks import ResNetStack
from ..nn.conv import SparseConv
from ..nn.init import init_parameters
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
                 device=None):
        super().__init__()
        if with_window_attn:
            raise NotImplementedError(
                "the encoder's Morton-window attention is not ported yet")
        ch, caps = tuple(channels), tuple(level_capacities)
        self.block1 = ResNetStack(in_channels, ch[0], after="downsample",
                                  out_capacity=caps[0], device=device)
        self.block2 = ResNetStack(ch[0], ch[1], after="downsample",
                                  out_capacity=caps[1], device=device)
        self.block3 = ResNetStack(ch[1], ch[2], after="downsample",
                                  out_capacity=caps[2], device=device)
        self.block4 = ResNetStack(ch[2], ch[3], device=device)
        self.block5 = ResNetStack(ch[3], ch[4], device=device)
        self.mean_conv = SparseConv(ch[4], ch[4], kernel_size=3, device=device)
        self.log_var_conv = SparseConv(ch[4], ch[4], kernel_size=3,
                                       device=device)

    def forward(self, x: SparseTensor):
        for blk in (self.block1, self.block2, self.block3, self.block4,
                    self.block5):
            x = blk(x)
        return self.mean_conv(x), self.log_var_conv(x)


class Decoder(nn.Module):
    """``channels`` are the encoder's reversed, e.g. (4, 512, 512, 128, 32);
    ``level_capacities`` the candidate-set buffer of each level, coarse to
    fine."""

    def __init__(self, channels: Sequence[int] = (4, 512, 512, 128, 32),
                 level_capacities: Sequence[int] = (2048, 8192, 16384, 32768),
                 max_keep: Optional[int] = None, device=None):
        super().__init__()
        ch = tuple(channels)
        self.level_capacities = tuple(level_capacities)
        self.max_keep = max_keep
        for lvl in range(4):
            setattr(self, f"block{lvl + 1}", ResNetStack(
                ch[lvl], ch[lvl + 1], after=None if lvl == 0 else "upsample",
                out_capacity=self.level_capacities[lvl], device=device))
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
                 with_window_attn: bool = False, latent_canvas: bool = False,
                 device=None, seed: int = 0):
        super().__init__()
        if latent_canvas:
            raise NotImplementedError(
                "the dense latent canvas (ops/canvas.py) is not ported yet")
        dev = resolve_device(device)
        self.encoder = Encoder(channels, encoder_capacities, in_channels,
                               with_window_attn, device=dev)
        self.decoder = Decoder(tuple(reversed(tuple(channels))),
                               decoder_capacities, max_keep, device=dev)
        init_parameters(self, make_generator(seed, dev))
        self.eval()

    def encode(self, sinput: SparseTensor):
        return self.encoder(sinput)

    def decode(self, z: SparseTensor, target_grid: SparseGrid):
        return self.decoder(z, target_grid)

    def forward(self, sinput: SparseTensor, target_grid: SparseGrid,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """encode → reparameterize → decode.  ``eps`` is the N(0,1) noise
        of the reparameterisation, shaped like the latent's features; when
        it is not given it is drawn from ``generator``.  Returns (out_clss,
        targets, sout, mean, log_var, z)."""
        mean, log_var = self.encode(sinput)
        if eps is None:
            eps = torch.randn(log_var.features.shape, generator=generator,
                              device=log_var.features.device)
        z = mean.with_features(mean.features +
                               torch.exp(0.5 * log_var.features) * eps)
        out_clss, targets, sout = self.decode(z, target_grid)
        return out_clss, targets, sout, mean, log_var, z


def vae_loss(out_clss, targets, mean: SparseTensor, log_var: SparseTensor,
             kld_weight: float = 1e-6):
    """Per-level masked BCE-with-logits averaged over levels + KLD over the
    valid latent rows → (loss, {"bce", "kld"})."""
    bce = 0.0
    for logits_t, target in zip(out_clss, targets):
        lo = logits_t.features[:, 0]
        v = logits_t.valid
        t = target.to(lo.dtype)
        per = lo.clamp(min=0.0) - lo * t + torch.log1p(torch.exp(-lo.abs()))
        bce = bce + torch.where(v, per, 0.0).sum() / v.to(lo.dtype).sum(
        ).clamp(min=1.0)
    bce = bce / float(len(out_clss))
    vmask = mean.valid[:, None].to(mean.features.dtype)
    kld = -0.5 * ((1 + log_var.features - mean.features ** 2 -
                   torch.exp(log_var.features)) * vmask).sum() / (
        vmask.sum().clamp(min=1.0))
    return bce + kld_weight * kld, {"bce": bce, "kld": kld}
