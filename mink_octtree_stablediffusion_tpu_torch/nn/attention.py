"""Per-instance attention over sparse tensors.

Port of `_mha`, `SparseAttention` (self-attention) and `SparseTransformer`
from `mink_octtree_stablediffusion_tpu/nn/attention.py`: the voxels of each
batch instance are packed into a ``[B, L_max, C]`` buffer with a
key-padding mask, attention runs as dense batched matmuls, and rows are
scattered back.  ``_mha`` is plain PyTorch: a query whose keys are all
masked gets zero weights (``scaled_dot_product_attention`` would give NaN
there).  Cross-attention and the Morton-window transformer are not ported
yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..tensor import SparseTensor
from .linear import Dense

_NEG = -1e9


def _mha(q, k, v, mask, num_heads: int):
    """Masked multi-head attention core. q [B,Lq,C], k/v [B,Lk,C],
    mask bool[B,Lk] (True = attend)."""
    b, lq, c = q.shape
    lk = k.shape[1]
    hd = c // num_heads
    qh = q.reshape(b, lq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(b, lk, num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, lk, num_heads, hd).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
    m = mask[:, None, None, :]
    logits = torch.where(m, logits, _NEG)
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = w * m.to(w.dtype)
    w = w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return (w @ vh).transpose(1, 2).reshape(b, lq, c)


class SparseAttention(nn.Module):
    """One residual self-attention layer: to_q / to_kv without bias, to_out
    with bias."""

    def __init__(self, channels: int, num_heads: int = 1,
                 cross_attention_dim=None, device=None):
        super().__init__()
        if cross_attention_dim is not None:
            raise NotImplementedError(
                "cross-attention is not ported yet (ROADMAP.md queue A)")
        self.num_heads = num_heads
        self.to_q = Dense(channels, channels, bias=False, device=device)
        self.to_kv = Dense(channels, 2 * channels, bias=False, device=device)
        self.to_out = Dense(channels, channels, bias=True, device=device)

    def forward(self, packed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        k, v = self.to_kv(packed).chunk(2, dim=-1)
        out = _mha(self.to_q(packed), k, v, mask, self.num_heads)
        return self.to_out(out) + packed


class SparseTransformer(nn.Module):
    """Pack → attention → unpack on a SparseTensor.  The pack length is
    clamped to the grid's static per-instance cell bound (rounded up to
    128) and to the buffer's capacity."""

    def __init__(self, channels: int, max_len: int, num_heads: int = 1,
                 device=None):
        super().__init__()
        self.max_len = max_len
        self.attn = SparseAttention(channels, num_heads, device=device)

    def forward(self, x: SparseTensor) -> SparseTensor:
        max_len = max(min(self.max_len, x.capacity), 1)
        if x.grid.extent is not None:
            cells = int(np.prod([-(-int(e) // int(s)) for e, s in
                                 zip(x.grid.extent, x.grid.stride)]))
            max_len = max(min(max_len, -(-cells // 128) * 128), 1)
        packed, mask, pos = x.decomposed_features(max_len)
        out = self.attn(packed, mask)
        out = out * mask[..., None].to(out.dtype)
        return x.from_decomposed(out, pos)
