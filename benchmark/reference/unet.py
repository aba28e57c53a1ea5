"""The sparse latent UNet's noise prediction and the DDIM step in plain
PyTorch (the reference's ``examples/diffusion.py``).

conv_in (k3) → three down groups of two stages (the first with a k3
stride-2 head into a buffer of its own), a middle group of two stages,
three up groups of three stages (the first with a generative k2-s2 head
onto the octree children, the last ending on the matching down grid) with
the down group's output concatenated after each, → conv_out (k3).  A
stage: head conv (stride-2 / generative / k3), instance norm, ELU; two
residual blocks; a tail k3 conv (onto the pinned grid where there is
one), instance norm, ELU.  A residual block: k3 conv, instance norm, the
timestep embedding's projection added per instance, ELU, k3 conv,
instance norm, the skip added; where the group has attention, ELU and a
residual single-head self-attention over each instance's cells; ELU.  The instance
norm averages each instance's mean and variance over groups of
``group`` channels, with one scale and shift a group.  The timestep
embedding: [cos, sin] features, dense, SiLU, dense.

Every level keeps every cell: the reference has no buffers.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import sparse as sp


def instance_norm(P, name, f, grid: sp.Grid, group: int, eps=1e-6):
    w, b = P[name + ".weight"], P[name + ".bias"]
    g = f.shape[1] // w.shape[0]
    bid = grid.coords[:, 0]
    nb = grid.batch
    cnt = torch.zeros(nb, device=f.device, dtype=f.dtype).index_add_(
        0, bid, torch.ones_like(bid, dtype=f.dtype)).clamp(min=1)[:, None]

    def group_avg(v):
        return v.reshape(nb, -1, g).mean(-1).repeat_interleave(g, dim=1)
    mean = f.new_zeros(nb, f.shape[1]).index_add_(
        0, bid, f) / cnt
    c = f - group_avg(mean)[bid]
    var = f.new_zeros(nb, f.shape[1]).index_add_(
        0, bid, c * c) / cnt
    y = c * (1.0 / torch.sqrt(group_avg(var) + eps))[bid]
    return y * w.repeat_interleave(g) + b.repeat_interleave(g)


def dense(P, name, x):
    b = P.get(name + ".bias")
    return F.linear(x, P[name + ".weight"], b)


def attention(P, name, f, grid: sp.Grid):
    """Residual single-head self-attention within each instance."""
    bid = grid.coords[:, 0]
    out = torch.zeros_like(f)
    q = dense(P, name + ".to_q", f)
    k, v = dense(P, name + ".to_kv", f).chunk(2, dim=-1)
    scale = 1.0 / math.sqrt(f.shape[1])
    for b in range(grid.batch):
        rows = (bid == b).nonzero()[:, 0]
        if len(rows) == 0:
            continue
        w = torch.softmax(sp.product(q[rows], k[rows].T) * scale, dim=-1)
        a = sp.product(w, v[rows])
        out[rows] = dense(P, name + ".to_out", a) + f[rows]
    return out


class UNet:
    """The noise prediction ``eps = unet(x, t)`` on a fixed latent grid."""

    def __init__(self, P: Dict[str, torch.Tensor], channels: Sequence[int],
                 group: int, with_attn: bool = True):
        self.P, self.ch, self.group = P, list(channels), group
        self.with_attn = with_attn
        # each stage's grid a latent grid (held, so that the kernel maps
        # of ``sparse.cached_maps`` find them again at the next step)
        self._grids: dict = {}

    def _grid(self, name: str, grid: sp.Grid, make) -> sp.Grid:
        key = (name, id(grid))
        if key not in self._grids:
            self._grids[key] = (grid, make(grid))
        return self._grids[key][1]

    def block(self, name, f, grid, temb, attn):
        P, g = self.P, self.group
        o = instance_norm(P, name + ".norm1.inorm",
                          sp.conv_same(f, P[name + ".conv1.kernel"], grid),
                          grid, g)
        e = dense(P, name + ".time_emb_proj", F.elu(temb))
        o = F.elu(o + e[grid.coords[:, 0]])
        o = instance_norm(P, name + ".norm2.inorm",
                          sp.conv_same(o, P[name + ".conv2.kernel"], grid),
                          grid, g)
        o = o + f
        if attn:
            o = attention(P, name + ".attentions.attn", F.elu(o), grid)
        return F.elu(o)

    def stack(self, name, f, grid, temb, head, attn, pin=None):
        """head: "down", "up" or "same"; ``pin`` the grid the tail ends on
        → (grid, features)."""
        P = self.P
        w = P[name + ".head.conv.kernel"]
        if head == "down":
            h, grid = sp.conv_down(f, w, grid, self._grid(name, grid,
                                                          sp.coarsened))
        elif head == "up":
            out = self._grid(name, grid, sp.children)
            h, grid = sp.conv_up(f, w, grid, out), out
        else:
            h = sp.conv_same(f, w, grid)
        h = F.elu(instance_norm(P, name + ".head.norm.inorm", h, grid,
                                self.group))
        for j in (1, 2):
            h = self.block(f"{name}.block{j}", h, grid, temb, attn)
        tail = P[name + ".tail.conv.kernel"]
        if pin is not None:
            h = sp.conv(h, tail, grid, pin, sp.offsets(3, grid.stride,
                                                       h.device))
            grid = pin
        else:
            h = sp.conv_same(h, tail, grid)
        h = F.elu(instance_norm(P, name + ".tail.norm.inorm", h, grid,
                                self.group))
        return grid, h

    def time_embedding(self, t: int, batch: int, device,
                       dtype=torch.float32) -> torch.Tensor:
        tt = torch.full((batch,), float(t), device=device, dtype=dtype)
        half = self.ch[0] // 2
        freq = torch.exp(-math.log(10000.0) * torch.arange(
            half, device=device, dtype=dtype) / half)
        emb = torch.cat([torch.cos(tt[:, None] * freq),
                         torch.sin(tt[:, None] * freq)], 1)
        return dense(self.P, "time_embedding.linear_2", F.silu(
            dense(self.P, "time_embedding.linear_1", emb)))

    def __call__(self, x: torch.Tensor, grid: sp.Grid, t: int
                 ) -> torch.Tensor:
        P = self.P
        temb = self.time_embedding(t, grid.batch, x.device, x.dtype)
        h = sp.conv_same(x, P["conv_in.kernel"], grid)
        g0 = g = grid
        skips = []
        for name, attn in (("block1", self.with_attn),
                           ("block2", self.with_attn), ("block3", False)):
            for i in range(2):
                g, h = self.stack(f"{name}_{i}", h, g, temb,
                                  "down" if i == 0 else "same", attn)
            skips.append((g, h))
        for i in range(2):
            g, h = self.stack(f"res_mid_{i}", h, g, temb, "same",
                              self.with_attn)
        targets = [skips[1], skips[0], (g0, None)]
        for gi, (name, attn) in enumerate((("block3_tr", False),
                                           ("block2_tr", self.with_attn),
                                           ("block1_tr", self.with_attn))):
            pin_grid, pin_f = targets[gi]
            for i in range(3):
                g, h = self.stack(
                    f"{name}_{i}", h, g, temb, "up" if i == 0 else "same",
                    attn, pin_grid if i == 2 else None)
            if pin_f is not None:
                h = torch.cat([h, pin_f], 1)
        return sp.conv_same(h, P["conv_out.kernel"], g0)


class DDIM:
    """Deterministic DDIM (eta 0) on the scaled-linear β schedule of 1000
    steps (β from 0.00085 to 0.012), ᾱ of the final step 1."""

    def __init__(self, steps: int, train_steps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012):
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, train_steps,
                            dtype=np.float64) ** 2
        self.ac = np.cumprod(1.0 - betas)
        stride = train_steps // steps
        self.timesteps = [int(t) for t in (np.arange(steps) * stride)[::-1]]

    def step(self, eps: torch.Tensor, i: int, x: torch.Tensor
             ) -> torch.Tensor:
        t = self.timesteps[i]
        prev = self.timesteps[i + 1] if i + 1 < len(self.timesteps) else -1
        a_t = float(self.ac[t])
        a_p = float(self.ac[prev]) if prev >= 0 else 1.0
        x0 = (x - math.sqrt(1 - a_t) * eps) / math.sqrt(a_t)
        return math.sqrt(a_p) * x0 + math.sqrt(1 - a_p) * eps
