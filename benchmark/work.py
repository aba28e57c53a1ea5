"""Operation and byte counts: the yardstick of the rooflines and of the
model FLOPs.

- A sparse convolution does ``2 · Cin · Cout`` operations per matched
  (input, output, offset) pair.  ``launch_pairs`` counts the pairs of one
  launch of the fused conv kernels from its operands: the output rows'
  queries ``out + offset`` on the input lattice, matched against the
  sorted input keys.  ``launch_work`` turns a recorded launch into
  (operations, bytes), each input read once and each output written once.
- ``bound_seconds``: the least time of a launch on one H100, the larger of
  its operations at the bf16 dense peak and its bytes at the HBM peak.
- ``vae_train_flops`` and ``minkunet_train_flops``: the model FLOPs of one
  training step (three times the forward), from the input voxels and the
  configuration's widths, whatever route the program takes for a conv.
  The VAE decoder is counted on the cells that training forces it to
  keep (the target cells), which it keeps at least.  (Generation's FLOPs
  are the reference's own count, ``reference.sparse.counting``.)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .reference import sparse as sp

PEAK_FLOPS = 989e12  # H100 SXM, bf16 dense (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3
INT32_MAX = 2 ** 31 - 1


def launch_pairs(in_keys: torch.Tensor, out_coords: torch.Tensor,
                 out_valid: torch.Tensor, offs: np.ndarray, s_in,
                 cells) -> int:
    """Matched (output row, offset) pairs of one launch."""
    off = torch.as_tensor(np.asarray(offs), dtype=torch.long,
                          device=out_coords.device)
    q = out_coords[:, None, 1:].long() + off[None]
    key = out_coords[:, :1].long().expand(-1, off.shape[0])
    ok = out_valid[:, None].expand(-1, off.shape[0])
    for i, (s, c) in enumerate(zip(s_in, cells)):
        pos = torch.div(q[..., i], s, rounding_mode="floor")
        ok = ok & (q[..., i] == pos * s) & (pos >= 0) & (pos < c)
        key = key * c + pos
    keys = in_keys.long()
    n = keys.shape[0]
    pos = torch.searchsorted(keys, key.reshape(-1)).clamp(max=n - 1)
    hit = ok.reshape(-1) & (keys[pos] == key.reshape(-1))
    return int(hit.sum())


def launch_work(kind: str, fshape, kernel_or_g, in_keys, out_coords,
                out_valid, offs, s_in, cells) -> tuple:
    """(operations, bytes) of a recorded launch whose features are
    ``fshape`` [N_in, Cin]: ``kind`` B1 (``kernel`` [K, Cin, Cout]), B2
    (``kernel`` the forward's [K, Cout, Cin], the products transposed) or
    B3 (the shape of ``g``, [N_out, Cout]; dW written)."""
    pairs = launch_pairs(in_keys, out_coords, out_valid, offs, s_in, cells)
    k = np.asarray(offs).shape[0]
    n_in = int((in_keys != INT32_MAX).sum())
    n_out = int(out_valid.sum())
    cin = fshape[1]
    if kind == "B3":
        cout = kernel_or_g[1]
        moved = (n_in * cin + n_out * cout + k * cin * cout) * 4
    else:
        w = kernel_or_g
        cout = w.shape[1] if kind == "B2" else w.shape[2]
        moved = (n_in * cin + n_out * cout) * 4 + w.numel() * w.element_size()
    moved += n_in * 4 + n_out * 4 * out_coords.shape[1]  # keys, coordinates
    return 2 * cin * cout * pairs, moved


def bound_seconds(ops: float, moved: float) -> float:
    return max(ops / PEAK_FLOPS, moved / PEAK_BYTES)


# -- model FLOPs ---------------------------------------------------------------


def _pairs(in_grid: sp.Grid, out_grid: sp.Grid, offs, sign: int = 1) -> int:
    return int((sp.kernel_map(in_grid, out_grid, offs, sign) >= 0).sum())


def _same(grid: sp.Grid, k: int) -> int:
    return _pairs(grid, grid, sp.offsets(k, grid.stride, grid.coords.device))


def vae_train_flops(coords: torch.Tensor, *, extent: int, batch: int,
                    channels: Sequence[int]) -> float:
    """Model FLOPs of one VAE training step on the input voxels ``coords``
    [N, 4]: 3 × the forward's products."""
    ch = list(channels)
    grid = sp.make_grid(coords, 1, extent, batch)
    target = grid
    fl = 0
    cin = 1
    for i in range(5):
        if i < 3:
            out = sp.make_grid(grid.coords, 2 * grid.stride, extent, batch)
            fl += _pairs(grid, out, sp.offsets(3, grid.stride,
                                               coords.device)) * cin * ch[i]
            grid = out
        else:
            fl += _same(grid, 3) * cin * ch[i]
        fl += 2 * _same(grid, 3) * ch[i] * ch[i]
        cin = ch[i]
    fl += 2 * _same(grid, 3) * ch[4] * ch[4]  # mean and log-variance heads
    dch = ch[::-1]
    for lvl in range(4):
        cin, cout = dch[lvl], dch[lvl + 1]
        if lvl == 0:
            fl += _same(grid, 3) * cin * cout
        else:
            out = sp.children(grid)
            fl += _pairs(grid, out, sp.offsets(2, out.stride, coords.device),
                         -1) * cin * cout
            grid = out
        fl += 2 * _same(grid, 3) * cout * cout + len(grid) * cout  # + head
        if lvl < 3:  # the forced cells: the targets at this stride
            strided = sp.make_grid(target.coords, grid.stride, extent, batch)
            grid = sp.Grid(grid.coords[sp.member(grid, strided)],
                           grid.stride, extent, batch)
    return 3.0 * 2.0 * fl


def minkunet_train_flops(coords: torch.Tensor, *, extent: int, batch: int,
                         in_channels: int, init_dim: int,
                         planes: Sequence[int], layers: Sequence[int],
                         out_channels: int) -> float:
    """Model FLOPs of one MinkUNet training step: 3 × the forward."""
    p = list(planes)
    dev = coords.device
    grids = [sp.make_grid(coords, 1, extent, batch)]
    fl = _pairs(grids[0], grids[0], sp.offsets(5, 1, dev)) * in_channels \
        * init_dim

    def stage(grid, cin, planes_, n):
        f = 0
        for j in range(n):
            f += _same(grid, 3) * (cin * planes_ + planes_ * planes_)
            if cin != planes_:
                f += len(grid) * cin * planes_
            cin = planes_
        return f

    cin = init_dim
    for i in range(1, 5):
        g = grids[-1]
        out = sp.make_grid(g.coords, 2 * g.stride, extent, batch)
        fl += _pairs(g, out, sp.offsets(2, g.stride, dev)) * cin * cin
        grids.append(out)
        fl += stage(out, cin, p[i - 1], layers[i - 1])
        cin = p[i - 1]
    skips = (p[2], p[1], p[0], init_dim)
    for j, i in enumerate((4, 5, 6, 7)):
        g, out = grids[4 - j], grids[3 - j]
        fl += _pairs(g, out, sp.offsets(2, out.stride, dev), -1) * cin * p[i]
        fl += stage(out, p[i] + skips[j], p[i], layers[i])
        cin = p[i]
    fl += len(grids[0]) * cin * out_channels
    return 3.0 * 2.0 * fl
