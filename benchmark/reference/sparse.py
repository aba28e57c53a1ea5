"""Plain PyTorch sparse tensors for the reference networks.

A voxel set is a ``Grid``: integer coordinates ``[N, 4]`` (batch, x, y, z)
on the lattice of its ``stride``, held sorted by the row-major cell key
``((b·C + x/s)·C + y/s)·C + z/s`` with ``C = ceil(extent / s)``, one row
per cell, every cell kept: a reference network has no buffers.
Neighbours are found by ``searchsorted`` on the keys; a convolution is a
gather, one matrix product per kernel offset, and a sum.

The products run in float32 with TF32 off, or, for the control runs, with
their operands rounded to a lower precision (``set_precision``): bf16, or
fp8 (e4m3) or int8 (symmetric) with one scale per operand tensor, in the
forward and in both products of the backward.  Nothing here imports the program under test.
"""

from __future__ import annotations

import itertools
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

_PRECISION = "float32"
PRECISIONS = ("float32", "bfloat16", "float8", "int8")
FP8_MAX = 448.0
# model FLOPs counted while ``counting()`` is open: a conv's matched pairs
# times 2·Cin·Cout, every other product 2·m·k·n
_FLOPS: list = []
# kernel maps of grids held by the caller across calls (``cached_maps``)
_MAPS: dict = {}
_CACHE = [False]


def set_precision(name: str) -> None:
    """The rounding of every convolution's product operands."""
    global _PRECISION
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r} not in {PRECISIONS}")
    _PRECISION = name


def get_precision() -> str:
    return _PRECISION


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rounded(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the set precision, back in float32."""
    if _PRECISION == "float32":
        return x
    if _PRECISION == "bfloat16":
        return x.to(torch.bfloat16).float()
    amax = x.detach().abs().amax().clamp(min=1e-30)
    if _PRECISION == "int8":
        scale = amax / 127.0
        return torch.round(x / scale).clamp(-127, 127) * scale
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Product(torch.autograd.Function):
    """``a @ w`` with both operands rounded, and the cotangent rounded in
    the two products of the backward."""

    @staticmethod
    def forward(ctx, a, w):
        ar, wr = rounded(a), rounded(w)
        ctx.save_for_backward(ar, wr)
        return ar @ wr

    @staticmethod
    def backward(ctx, g):
        ar, wr = ctx.saved_tensors
        gr = rounded(g)
        return gr @ wr.T, ar.T @ gr


def product(a: torch.Tensor, w: torch.Tensor, count: bool = True
            ) -> torch.Tensor:
    if count and _FLOPS:
        _FLOPS[-1] += 2.0 * a.shape[0] * a.shape[1] * w.shape[1]
    if _PRECISION == "float32":
        return a @ w
    return _Product.apply(a, w)


@contextmanager
def counting():
    """Count the model FLOPs of the products inside the block: yields a
    one-element list that holds the total once the block has closed."""
    _FLOPS.append(0.0)
    box = [0.0]
    try:
        yield box
    finally:
        box[0] = _FLOPS.pop()


@contextmanager
def cached_maps():
    """Keep the kernel maps of the grids used inside the block (the caller
    holds the grids, so their identity stays)."""
    _CACHE[0] = True
    try:
        yield
    finally:
        _CACHE[0] = False
        _MAPS.clear()


@dataclass
class Grid:
    coords: torch.Tensor  # int64 [N, 4], sorted by key, distinct cells
    stride: int
    extent: int
    batch: int

    @property
    def cells(self) -> int:
        return -(-self.extent // self.stride)

    @property
    def keys(self) -> torch.Tensor:
        return cell_keys(self.coords, self.stride, self.extent)

    def __len__(self) -> int:
        return self.coords.shape[0]


def cell_keys(coords: torch.Tensor, stride: int, extent: int
              ) -> torch.Tensor:
    """Row-major cell key of lattice coordinates [N, 4]; -1 where a
    coordinate is off the lattice or outside ``[0, extent)``."""
    c = -(-extent // stride)
    xyz = coords[:, 1:]
    pos = torch.div(xyz, stride, rounding_mode="floor")
    ok = ((pos * stride == xyz) & (pos >= 0) & (pos < c)).all(1)
    key = coords[:, 0]
    for i in range(3):
        key = key * c + pos[:, i]
    return torch.where(ok, key, -1)


def from_keys(keys: torch.Tensor, stride: int, extent: int) -> torch.Tensor:
    c = -(-extent // stride)
    out = []
    k = keys
    for _ in range(3):
        out.append(k % c * stride)
        k = k // c
    return torch.stack([k] + out[::-1], 1)


def make_grid(coords: torch.Tensor, stride: int, extent: int, batch: int
              ) -> Grid:
    """The distinct cells of ``coords`` [N, 4] coarsened to ``stride``,
    sorted."""
    coords = coords.long()
    xyz = torch.div(coords[:, 1:], stride, rounding_mode="floor") * stride
    keys = cell_keys(torch.cat([coords[:, :1], xyz], 1), stride, extent)
    keys = torch.unique(keys[keys >= 0])
    return Grid(from_keys(keys, stride, extent), stride, extent, batch)


def lookup(grid: Grid, coords: torch.Tensor) -> torch.Tensor:
    """Row of ``grid`` holding each coordinate [M, 4], -1 where none."""
    q = cell_keys(coords, grid.stride, grid.extent)
    keys = grid.keys
    if len(keys) == 0:
        return torch.full_like(q, -1)
    pos = torch.searchsorted(keys, q).clamp(max=len(keys) - 1)
    return torch.where((q >= 0) & (keys[pos] == q), pos, -1)


def offsets(kernel_size: int, unit: int, device) -> torch.Tensor:
    """Kernel offsets [K, 3] in lattice units of ``unit``: odd sizes
    centred, even ones over [0, k); the first axis slowest."""
    lo = (kernel_size - 1) // 2
    axis = [i - lo for i in range(kernel_size)]
    return torch.tensor(list(itertools.product(axis, axis, axis)),
                        dtype=torch.long, device=device) * unit


def kernel_map(in_grid: Grid, out_grid: Grid, offs: torch.Tensor,
               sign: int = 1) -> torch.Tensor:
    """[K, N_out]: the input row at ``out + sign·offset`` (-1 if none)."""
    key = (id(in_grid), id(out_grid), tuple(offs.reshape(-1).tolist()), sign)
    if _CACHE[0] and key in _MAPS:
        return _MAPS[key][2]
    out = []
    for d in offs:
        q = out_grid.coords.clone()
        q[:, 1:] += sign * d
        out.append(lookup(in_grid, q))
    out = torch.stack(out) if out else torch.empty(
        (0, len(out_grid)), dtype=torch.long, device=offs.device)
    if _CACHE[0]:
        _MAPS[key] = (in_grid, out_grid, out)
    return out


class _Gather(torch.autograd.Function):
    """``f[idx]`` with zero rows where ``idx`` is -1; the backward sums the
    cotangent rows into their sources with ``index_add_`` (the backward of
    plain indexing sorts the indices first, which is many times slower at
    these sizes)."""

    @staticmethod
    def forward(ctx, f, idx):
        ok = idx >= 0
        src = idx.clamp(min=0)
        ctx.save_for_backward(src, ok)
        ctx.rows = f.shape[0]
        return f[src] * ok[:, None].to(f.dtype)

    @staticmethod
    def backward(ctx, g):
        src, ok = ctx.saved_tensors
        out = g.new_zeros((ctx.rows, g.shape[1]))
        return out.index_add_(0, src, g * ok[:, None].to(g.dtype)), None


def gather(f: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``f[idx]``, zero where ``idx`` is -1."""
    return _Gather.apply(f, idx)


def conv(f: torch.Tensor, w: torch.Tensor, in_grid: Grid, out_grid: Grid,
         offs: torch.Tensor, sign: int = 1,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[j] = Σ_k f[in(j, k)] · w[k]`` over the matched neighbours."""
    nmap = kernel_map(in_grid, out_grid, offs, sign)
    if _FLOPS:
        _FLOPS[-1] += 2.0 * float((nmap >= 0).sum()) * w.shape[1] * w.shape[2]
    g = gather(f, nmap.T.reshape(-1)).reshape(nmap.shape[1], -1)
    out = product(g, w.reshape(-1, w.shape[2]), count=False)
    return out if bias is None else out + bias


def conv_same(f, w, grid: Grid, bias=None):
    """Stride-1 conv of odd size on one grid."""
    k = round(w.shape[0] ** (1 / 3))
    return conv(f, w, grid, grid, offsets(k, grid.stride, f.device),
                bias=bias)


def conv_down(f, w, grid: Grid, out: Optional[Grid] = None):
    """Stride-2 conv (odd or even size) onto the coarsened grid (``out``
    where the caller holds it)."""
    k = round(w.shape[0] ** (1 / 3))
    if out is None:
        out = coarsened(grid)
    return conv(f, w, grid, out, offsets(k, grid.stride, f.device)), out


def coarsened(grid: Grid) -> Grid:
    return make_grid(grid.coords, 2 * grid.stride, grid.extent, grid.batch)


def children(grid: Grid) -> Grid:
    """The octree children of every cell at half the stride."""
    s = grid.stride // 2
    d = offsets(2, s, grid.coords.device)
    c = grid.coords[:, None, :].repeat(1, 8, 1)
    c[:, :, 1:] += d[None]
    return make_grid(c.reshape(-1, 4), s, grid.extent, grid.batch)


def conv_up(f, w, grid: Grid, out: Grid):
    """k2-s2 transpose conv onto a finer grid ``out``: ``in = out −
    offset``."""
    return conv(f, w, grid, out, offsets(2, out.stride, f.device), sign=-1)


def batch_norm(f: torch.Tensor, weight, bias, eps: float = 1e-5):
    """Training-mode batch norm over the rows, biased variance."""
    mean = f.mean(0)
    var = (f.pow(2).mean(0) - mean ** 2).clamp(min=0.0)
    return (f - mean) * torch.rsqrt(var + eps) * weight + bias


def member(grid: Grid, target: Grid) -> torch.Tensor:
    return lookup(target, grid.coords) >= 0


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor):
    return F.binary_cross_entropy_with_logits(logits, target.float())


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)
