"""Timestep embeddings (port of `nn/embed.py`): sinusoidal features and
the two-layer SiLU MLP of diffusers' `TimestepEmbedding`."""

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
