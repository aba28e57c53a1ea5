"""Per-instance attention over sparse tensors.

Port of `_mha`, `SparseAttention`, `SparseTransformer` and
`MortonWindowTransformer` from
`mink_octtree_stablediffusion_tpu/nn/attention.py`: the voxels of each
batch instance are packed into a ``[B, L_max, C]`` buffer with a
key-padding mask, attention runs as dense batched matmuls, and rows are
scattered back.  Cross-attention reads its keys and values from an
``encoder_hidden_state`` [B, S, D_cross].  The window transformer
attends within fixed windows of the (batch, Morton) row order.  ``_mha``
is plain PyTorch: a query whose keys are all masked gets zero weights
(``scaled_dot_product_attention`` would give NaN there).

``record_attention()`` collects an :class:`AttentionRoute` for every
attention call, so a run can check which paths it took.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..ops.morton import morton_encode
from ..tensor import SparseTensor
from .linear import Dense

_NEG = -1e9
_INT32_MAX = int(np.iinfo(np.int32).max)


class AttentionRoute(NamedTuple):
    kind: str  # "full" | "cross" | "window"
    rows: int  # the tensor's capacity
    channels: int
    # keys per query: the pack length (full), the condition's tokens
    # (cross) or the window (window)
    keys: int


_ROUTES: Optional[list] = None


@contextlib.contextmanager
def record_attention():
    """Collect the :class:`AttentionRoute` of every attention call inside
    the block."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def _per_instance_cells(grid) -> int:
    """Static per-instance dense cell bound of a bounded grid (2^30 for
    an unbounded one, so that window attention then always engages)."""
    if grid.extent is None:
        return 1 << 30
    return int(np.prod([-(-int(e) // int(s))
                        for e, s in zip(grid.extent, grid.stride)]))


def _record(kind: str, x: SparseTensor, keys: int) -> None:
    if _ROUTES is not None:
        _ROUTES.append(AttentionRoute(kind, x.capacity, x.num_channels,
                                      keys))


def _mha(q, k, v, mask, num_heads: int):
    """Masked multi-head attention core. q [B,Lq,C], k/v [B,Lk,C], mask
    bool[B,Lk] or, per query, bool[B,Lq,Lk] (True = attend)."""
    b, lq, c = q.shape
    lk = k.shape[1]
    hd = c // num_heads
    qh = q.reshape(b, lq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(b, lk, num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, lk, num_heads, hd).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
    m = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
    logits = torch.where(m, logits, _NEG)
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = w * m.to(w.dtype)
    w = w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return (w @ vh).transpose(1, 2).reshape(b, lq, c)


class SparseAttention(nn.Module):
    """One residual attention layer: to_q / to_kv without bias, to_out
    with bias.  Self-attention, or cross-attention when
    ``cross_attention_dim`` is set: ``to_kv`` then reads the
    ``encoder_hidden_state`` [B, S, cross_attention_dim], whose keys are
    all attended unless ``encoder_mask`` [B, S] says otherwise."""

    def __init__(self, channels: int, num_heads: int = 1,
                 cross_attention_dim: Optional[int] = None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.cross_attention_dim = cross_attention_dim
        self.to_q = Dense(channels, channels, bias=False, device=device)
        self.to_kv = Dense(cross_attention_dim or channels, 2 * channels,
                           bias=False, device=device)
        self.to_out = Dense(channels, channels, bias=True, device=device)

    def forward(self, packed: torch.Tensor, mask: torch.Tensor,
                encoder_hidden_state: Optional[torch.Tensor] = None,
                encoder_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.cross_attention_dim is not None and \
                encoder_hidden_state is None:
            raise ValueError("cross-attention needs an encoder_hidden_state")
        ctx = packed if encoder_hidden_state is None else encoder_hidden_state
        k, v = self.to_kv(ctx).chunk(2, dim=-1)
        if encoder_hidden_state is None:
            kmask = mask
        else:
            kmask = (encoder_mask if encoder_mask is not None else
                     torch.ones(ctx.shape[:2], dtype=torch.bool,
                                device=ctx.device))
        out = _mha(self.to_q(packed), k, v, kmask, self.num_heads)
        return self.to_out(out) + packed


class SparseTransformer(nn.Module):
    """Pack → attention → unpack on a SparseTensor.  The pack length is
    clamped to the grid's static per-instance cell bound (rounded up to
    128) and to the buffer's capacity; rows past it in their instance
    come back zero.  With ``cross_attention_dim`` the queries are the
    packed rows and the keys the ``encoder_hidden_state``."""

    def __init__(self, channels: int, max_len: int, num_heads: int = 1,
                 cross_attention_dim: Optional[int] = None, device=None):
        super().__init__()
        self.max_len = max_len
        self.attn = SparseAttention(channels, num_heads, cross_attention_dim,
                                    device=device)

    def forward(self, x: SparseTensor,
                encoder_hidden_state: Optional[torch.Tensor] = None
                ) -> SparseTensor:
        max_len = max(min(self.max_len, x.capacity), 1)
        if x.grid.extent is not None:
            cells = _per_instance_cells(x.grid)
            max_len = max(min(max_len, -(-cells // 128) * 128), 1)
        packed, mask, pos = x.decomposed_features(max_len)
        out = self.attn(packed, mask, encoder_hidden_state)
        if self.attn.cross_attention_dim is None:
            _record("full", x, max_len)
        else:
            _record("cross", x, encoder_hidden_state.shape[1])
        out = out * mask[..., None].to(out.dtype)
        return x.from_decomposed(out, pos)


def morton_window_attention(x: SparseTensor, attn: SparseAttention,
                            window_size: int, interval: int = 1
                            ) -> SparseTensor:
    """Self-attention within windows of ``window_size`` rows of the
    (batch, Morton) order, with ``attn``'s projections: rows are sorted
    (invalid rows last), padded to a multiple of ``window_size·interval``,
    strided into dilated windows when ``interval > 1``, attend only to
    valid rows of their own instance within their window, go through
    ``to_out`` and are added back to their own rows as a residual.  An
    invalid row attends to nothing, so its residual is ``to_out``'s bias
    alone, which the tensor's mask then clears."""
    n, c = x.features.shape
    w, iv = window_size, interval
    _record("window", x, w)
    mcode = morton_encode(x.C[:, 1:], x.tensor_stride)
    bkey = torch.where(x.valid, x.C[:, 0].long(), _INT32_MAX)
    mkey = torch.where(x.valid, mcode.long(), _INT32_MAX)
    morder = torch.sort(bkey * (1 << 31) + mkey, stable=True).indices
    f = x.features[morder]
    m = x.valid[morder]
    bid = torch.where(m, x.C[morder, 0], -1)

    pad = (-n) % (w * iv)
    f = torch.cat([f, f.new_zeros(pad, c)])
    m = torch.cat([m, m.new_zeros(pad)])
    bid = torch.cat([bid, bid.new_full((pad,), -1)])
    if iv > 1:
        f = f.reshape(-1, iv, c).transpose(0, 1).reshape(-1, c)
        m = m.reshape(-1, iv).transpose(0, 1).reshape(-1)
        bid = bid.reshape(-1, iv).transpose(0, 1).reshape(-1)
    nw = f.shape[0] // w
    fw = f.reshape(nw, w, c)
    mw = m.reshape(nw, w)
    bw = bid.reshape(nw, w)
    same = (bw[:, :, None] == bw[:, None, :]) & mw[:, None, :]
    k, v = attn.to_kv(fw).chunk(2, dim=-1)
    out = _mha(attn.to_q(fw), k, v, same, attn.num_heads)
    out = attn.to_out(out).reshape(nw * w, c)
    if iv > 1:
        out = out.reshape(iv, -1, c).transpose(0, 1).reshape(-1, c)
    residual = torch.zeros_like(x.features).index_copy(0, morder, out[:n])
    return x.with_features(x.features + residual)


class MortonWindowTransformer(nn.Module):
    """Windowed self-attention over the Morton order with interval
    dilation (:func:`morton_window_attention`); the projections live in
    ``attn``, a :class:`SparseAttention`."""

    def __init__(self, channels: int, window_size: int = 64,
                 interval: int = 1, num_heads: int = 1, device=None):
        super().__init__()
        self.window_size = window_size
        self.interval = interval
        self.attn = SparseAttention(channels, num_heads, device=device)

    def forward(self, x: SparseTensor) -> SparseTensor:
        return morton_window_attention(x, self.attn, self.window_size,
                                       self.interval)
