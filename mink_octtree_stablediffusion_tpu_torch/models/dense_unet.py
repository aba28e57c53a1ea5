"""Dense 3D UNet baselines.

Port of `ResnetBlock3D`, `Attention3D`, `Downsample3D`, `Upsample3D`,
`UNet3DModel`, `DenseAttention`, `DenseTransformer3D` and
`UNet3DConditionModel` from
`mink_octtree_stablediffusion_tpu/models/dense_unet.py`: a diffusers-style
UNet over dense channel-last ``[B, D, H, W, C]`` voxel grids (GroupNorm +
SiLU ResNet blocks with a time-embedding FiLM, stride-2 conv down, nearest
2x + conv up, self-attention at coarse levels; the conditioned model adds
self + cross attention transformers).  There is no sparse machinery and no
kernel of the port here: the convolutions are ``F.conv3d`` (cuDNN) and the
attention is written as JAX writes it, ``matmul`` → ``softmax`` →
``matmul``, as the JAX package leaves both to XLA.

Where flax's defaults differ from PyTorch's, the port follows flax:
GroupNorm and LayerNorm ε = 1e-6; ``padding="SAME"`` pads
``(⌊p/2⌋, ⌈p/2⌉)``, so a stride-2 k3 conv on an even size pads (0, 1)
where ``F.conv3d(padding=1)`` would pad (1, 1) (the conv pads explicitly,
then convolves unpadded); ``jax.image.resize(..., "nearest")`` at exactly
2x is ``repeat_interleave(2)`` along each axis.  flax infers each layer's
input width; here it is tracked through the skip stack.  Names follow the
flax tree (``conv_in``, ``down{l}_res{i}``, ``down{l}_attn{i}``,
``down{l}_ds``, ``mid_res1``…); a conv's weight is ``[Cout, Cin, k, k, k]``
(`utils.convert` transposes flax's ``[k, k, k, Cin, Cout]``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.embed import TimestepEmbedding, timesteps_embedding
from ..nn.init import init_parameters
from ..nn.linear import Dense
from ..utils.device import make_generator, resolve_device


class Conv3d(nn.Module):
    """flax ``nn.Conv`` over channel-last 3-D grids with ``SAME`` padding,
    a bias, LeCun-normal initialisation."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, device=None):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        fan_in = self.weight[0].numel()
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.weight.shape[-1], self.stride
        pads = []
        for n in reversed(x.shape[1:4]):  # F.pad lists the last axis first
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        h = F.pad(x.permute(0, 4, 1, 2, 3), pads)
        return F.conv3d(h, self.weight, self.bias,
                        stride=s).permute(0, 2, 3, 4, 1)


# flax's GroupNorm and LayerNorm ε (torch's default is 1e-5).
NORM_EPS = 1e-6


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on a channel-last array: statistics over the
    spatial axes and each group's channels, the biased variance
    ``max(E[x²] − mean², 0)``, ε 1e-6, a per-channel scale and bias."""

    def __init__(self, num_groups: int, num_channels: int, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        xg = x.reshape(b, -1, g, c // g)
        mean = xg.mean((1, 3), keepdim=True)
        var = ((xg * xg).mean((1, 3), keepdim=True) -
               mean * mean).clamp(min=0.0)
        y = ((xg - mean) * torch.rsqrt(var + NORM_EPS)).reshape(x.shape)
        return y * self.weight + self.bias


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: over the last axis, the biased variance
    ``max(E[x²] − mean², 0)``, ε 1e-6, scale and bias."""

    def __init__(self, num_channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
        return (x - mean) * torch.rsqrt(var + NORM_EPS) * self.weight + \
            self.bias


def _attend(q, k, v, num_heads: int):
    """[B, L, C] queries over [B, S, C] keys/values, ``num_heads`` heads:
    ``softmax(q kᵀ / sqrt(hd)) v`` → [B, L, C]."""
    b, c = q.shape[0], q.shape[-1]
    hd = c // num_heads

    def heads(t):
        return t.reshape(b, -1, num_heads, hd).transpose(1, 2)

    logits = heads(q) @ heads(k).transpose(2, 3) / math.sqrt(hd)
    w = torch.softmax(logits, dim=-1)
    return (w @ heads(v)).transpose(1, 2).reshape(b, -1, c)


class ResnetBlock3D(nn.Module):
    """GN → SiLU → conv3 → (+ time embedding) → GN → SiLU → conv3 →
    + shortcut (a 1x1 conv where the width changes).  ``temb_channels``
    None: no time embedding."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 8,
                 time_embedding_norm: str = "default",
                 temb_channels: Optional[int] = None, device=None):
        super().__init__()
        c = out_channels
        self.time_embedding_norm = time_embedding_norm
        self.norm1 = GroupNorm(min(groups, in_channels), in_channels,
                               device=device)
        self.conv1 = Conv3d(in_channels, c, 3, device=device)
        self.time_emb_proj = (None if temb_channels is None else Dense(
            temb_channels, c if time_embedding_norm == "default" else 2 * c,
            device=device))
        self.norm2 = GroupNorm(min(groups, c), c, device=device)
        self.conv2 = Conv3d(c, c, 3, device=device)
        self.conv_shortcut = (Conv3d(in_channels, c, 1, device=device)
                              if in_channels != c else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and self.time_emb_proj is not None:
            e = self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
            if self.time_embedding_norm == "default":
                h = self.norm2(h + e)
            else:
                scale, shift = e.chunk(2, dim=-1)
                h = self.norm2(h) * (1 + scale) + shift
        else:
            h = self.norm2(h)
        h = self.conv2(F.silu(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention3D(nn.Module):
    """Self-attention over the flattened voxels: GN → ``qkv`` (with bias)
    → heads → ``proj`` → + x."""

    def __init__(self, channels: int, num_heads: int = 1, groups: int = 8,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm(min(groups, channels), channels, device=device)
        self.qkv = Dense(channels, 3 * channels, device=device)
        self.proj = Dense(channels, channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        h = self.norm(x).reshape(b, -1, c)
        q, k, v = self.qkv(h).chunk(3, dim=-1)
        o = self.proj(_attend(q, k, v, self.num_heads))
        return x + o.reshape(x.shape)


class Downsample3D(nn.Module):
    """Stride-2 k3 conv (``SAME``: (0, 1) padding on an even size)."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.conv = Conv3d(in_channels, out_channels, 3, 2, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample3D(nn.Module):
    """Nearest 2x upsample + k3 conv."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.conv = Conv3d(in_channels, out_channels, 3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for axis in (1, 2, 3):
            x = x.repeat_interleave(2, dim=axis)
        return self.conv(x)


class DenseAttention(nn.Module):
    """Residual attention over dense tokens: ``to_q``/``to_kv`` without
    bias, LayerNorm → SiLU → ``to_out`` (with bias), + the tokens; self
    attention, or cross attention on ``encoder_hidden_state`` [B, S,
    ``cross_attention_dim``] where that is set."""

    def __init__(self, channels: int, num_heads: int = 1,
                 cross_attention_dim: Optional[int] = None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.cross_attention_dim = cross_attention_dim
        c = channels
        self.to_q = Dense(c, c, bias=False, device=device)
        self.to_kv = Dense(cross_attention_dim or c, 2 * c, bias=False,
                           device=device)
        self.norm1 = LayerNorm(c, device=device)
        self.to_out = Dense(c, c, device=device)

    def forward(self, tokens: torch.Tensor,
                encoder_hidden_state: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if (encoder_hidden_state is not None and
                self.cross_attention_dim is not None and
                encoder_hidden_state.shape[-1] != self.cross_attention_dim):
            raise ValueError(
                f"encoder_hidden_state dim {encoder_hidden_state.shape[-1]} "
                f"!= declared cross_attention_dim {self.cross_attention_dim}")
        ctx = tokens if encoder_hidden_state is None else encoder_hidden_state
        k, v = self.to_kv(ctx).chunk(2, dim=-1)
        o = _attend(self.to_q(tokens), k, v, self.num_heads)
        return self.to_out(F.silu(self.norm1(o))) + tokens


class DenseTransformer3D(nn.Module):
    """Flatten [B, D, H, W, C] to voxel tokens → ``attn`` → restore."""

    def __init__(self, channels: int, num_heads: int = 1,
                 cross_attention_dim: Optional[int] = None, device=None):
        super().__init__()
        self.attn = DenseAttention(channels, num_heads, cross_attention_dim,
                                   device=device)

    def forward(self, x: torch.Tensor,
                encoder_hidden_state: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        return self.attn(x.reshape(b, -1, c),
                         encoder_hidden_state).reshape(x.shape)


class _UNet3DBase(nn.Module):
    """The backbone shared by both UNets; a subclass says which levels get
    which attention (``_attention``) and how it runs (``_attn``)."""

    def _build(self, in_channels, out_channels, block_channels,
               layers_per_block, groups, time_embedding_norm, temb, dev):
        ch = tuple(block_channels)
        self.block_channels, self.layers_per_block = ch, layers_per_block
        tch = ch[0] * 4 if temb else None
        self.time_embedding = (TimestepEmbedding(ch[0], tch, device=dev)
                               if temb else None)

        def res(name, cin, cout):
            setattr(self, name, ResnetBlock3D(cin, cout, groups,
                                              time_embedding_norm, tch,
                                              device=dev))

        self.conv_in = Conv3d(in_channels, ch[0], 3, device=dev)
        skips: List[int] = [ch[0]]
        for lvl, c in enumerate(ch):
            cin = skips[-1]
            for i in range(layers_per_block):
                res(f"down{lvl}_res{i}", cin, c)
                self._attention(f"down{lvl}_attn{i}", lvl, c, dev)
                skips.append(c)
                cin = c
            if lvl < len(ch) - 1:
                setattr(self, f"down{lvl}_ds", Downsample3D(c, c, device=dev))
                skips.append(c)
        res("mid_res1", ch[-1], ch[-1])
        self._attention("mid_attn", None, ch[-1], dev)
        res("mid_res2", ch[-1], ch[-1])
        h = ch[-1]
        for lvl in reversed(range(len(ch))):
            for i in range(layers_per_block + 1):
                res(f"up{lvl}_res{i}", h + skips.pop(), ch[lvl])
                self._attention(f"up{lvl}_attn{i}", lvl, ch[lvl], dev)
                h = ch[lvl]
            if lvl > 0:
                setattr(self, f"up{lvl}_us", Upsample3D(h, ch[lvl - 1],
                                                        device=dev))
                h = ch[lvl - 1]
        self.norm_out = GroupNorm(min(groups, h), h, device=dev)
        self.conv_out = Conv3d(h, out_channels, 3, device=dev)
        init_parameters(self, make_generator(self._seed, dev))
        self.eval()

    def _attention(self, name, lvl, channels, dev):
        raise NotImplementedError

    def _attn(self, name, h, context):
        raise NotImplementedError

    def _run(self, x, timesteps, context):
        ch = self.block_channels
        temb = None
        if timesteps is not None and self.time_embedding is not None:
            temb = self.time_embedding(timesteps_embedding(timesteps, ch[0]))
        h = self.conv_in(x)
        skips = [h]
        for lvl in range(len(ch)):
            for i in range(self.layers_per_block):
                h = getattr(self, f"down{lvl}_res{i}")(h, temb)
                h = self._attn(f"down{lvl}_attn{i}", h, context)
                skips.append(h)
            if lvl < len(ch) - 1:
                h = getattr(self, f"down{lvl}_ds")(h)
                skips.append(h)
        h = self.mid_res1(h, temb)
        h = self._attn("mid_attn", h, context)
        h = self.mid_res2(h, temb)
        for lvl in reversed(range(len(ch))):
            for i in range(self.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = getattr(self, f"up{lvl}_res{i}")(h, temb)
                h = self._attn(f"up{lvl}_attn{i}", h, context)
            if lvl > 0:
                h = getattr(self, f"up{lvl}_us")(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class UNet3DModel(_UNet3DBase):
    """``forward(x [B, D, H, W, in_channels], timesteps [B])`` →
    ``[B, D, H, W, out_channels]``; ``Attention3D`` after every ResNet
    block of the levels in ``attn_levels`` and in the middle.  Without
    ``time_embedding`` the model has no time MLP (JAX's tree when it is
    initialised without timesteps).  Random weights from ``seed``; a new
    model is in ``.eval()``."""

    def __init__(self, out_channels: int = 1, in_channels: int = 1,
                 block_channels: Sequence[int] = (32, 64, 128),
                 layers_per_block: int = 2, attn_levels: Sequence[int] = (2,),
                 groups: int = 8, time_embedding_norm: str = "default",
                 time_embedding: bool = True, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.attn_levels, self.groups, self._seed = (tuple(attn_levels),
                                                     groups, seed)
        self._build(in_channels, out_channels, block_channels,
                    layers_per_block, groups, time_embedding_norm,
                    time_embedding, dev)

    def _attention(self, name, lvl, channels, dev):
        if lvl is None or lvl in self.attn_levels:
            setattr(self, name, Attention3D(channels, groups=self.groups,
                                            device=dev))

    def _attn(self, name, h, context):
        mod = getattr(self, name, None)
        return h if mod is None else mod(h)

    def forward(self, x: torch.Tensor,
                timesteps: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._run(x, timesteps, None)


class UNet3DConditionModel(_UNet3DBase):
    """``forward(x, timesteps, encoder_hidden_states [B, S,
    cross_attention_dim] or None)``: the backbone plus, at each level of
    ``cross_attn_levels`` (default: all but the deepest) and in the middle
    (where any level has it), a self-attention transformer (``{tag}_self``)
    then a cross-attention one (``{tag}_cross``), with ``max(C //
    attention_head_dim, 1)`` heads; without ``encoder_hidden_states`` they
    are skipped.  Random weights from ``seed``; a new model is in
    ``.eval()``."""

    def __init__(self, out_channels: int = 4, in_channels: int = 4,
                 block_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, cross_attention_dim: int = 1024,
                 attention_head_dim: int = 64, groups: int = 32,
                 cross_attn_levels: Optional[Sequence[int]] = None,
                 time_embedding_norm: str = "default", device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        n = len(block_channels)
        self.xattn_levels = (tuple(range(n - 1)) if cross_attn_levels is None
                             else tuple(cross_attn_levels))
        self.cross_attention_dim = cross_attention_dim
        self.attention_head_dim = attention_head_dim
        self._seed = seed
        self._build(in_channels, out_channels, block_channels,
                    layers_per_block, groups, time_embedding_norm, True, dev)

    def _attention(self, name, lvl, channels, dev):
        if lvl is None:  # the middle: on where any level has it
            if not self.xattn_levels:
                return
        elif lvl not in self.xattn_levels:
            return
        heads = max(channels // self.attention_head_dim, 1)
        setattr(self, f"{name}_self", DenseTransformer3D(
            channels, heads, device=dev))
        setattr(self, f"{name}_cross", DenseTransformer3D(
            channels, heads, self.cross_attention_dim, device=dev))

    def _attn(self, name, h, context):
        if context is None or not hasattr(self, f"{name}_self"):
            return h
        h = getattr(self, f"{name}_self")(h)
        return getattr(self, f"{name}_cross")(h, context)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return self._run(x, timesteps, encoder_hidden_states)
