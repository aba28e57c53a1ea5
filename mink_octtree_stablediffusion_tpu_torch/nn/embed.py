"""Embeddings (port of `nn/embed.py`): sinusoidal timestep features, the
two-layer SiLU MLP of diffusers' `TimestepEmbedding`, and the linear
positional encoding of a sparse tensor's coordinates."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .linear import Dense


def timesteps_embedding(timesteps: torch.Tensor, dim: int,
                        flip_sin_to_cos: bool = True,
                        downscale_freq_shift: float = 0.0,
                        max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features [B, dim]."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """Dense → SiLU → Dense, lifting sinusoidal features to
    ``embedding_dim``."""

    def __init__(self, in_channels: int, embedding_dim: int, device=None):
        super().__init__()
        self.linear_1 = Dense(in_channels, embedding_dim, device=device)
        self.linear_2 = Dense(embedding_dim, embedding_dim, device=device)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class LinearPositionalEncoding(nn.Module):
    """(x, y, z, tensor stride) of every row → a dense layer ``fc`` (flax's
    ``Dense_0``) to ``d_model`` (the reference's
    `diffusion_block.py:377-397`)."""

    def __init__(self, d_model: int, ndim: int = 3, device=None):
        super().__init__()
        self.fc = Dense(ndim + 1, d_model, device=device)

    def forward(self, x) -> torch.Tensor:
        pos = torch.cat([x.C[:, 1:].to(torch.float32),
                         torch.full((x.capacity, 1),
                                    float(x.tensor_stride[0]),
                                    device=x.C.device)], dim=-1)
        return self.fc(pos)
