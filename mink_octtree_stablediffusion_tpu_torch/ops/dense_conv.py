"""Densify → dense conv → sparsify, for bounded grids that cannot grow.

Port of the "no-growth" branch of
`mink_octtree_stablediffusion_tpu/ops/dense_conv.py`: when the dense cell
count of a grid is no larger than its sparse buffer, scattering the
features onto the dense grid, running one dense convolution and gathering
the output rows back does less work than any sparse schedule.  Padding rows
hold zero features, so empty cells contribute exactly zero.

The JAX package's `lax.conv_general_dilated` (NDHWC / DHWIO) becomes
`F.conv3d` (NCDHW / OIDHW) and its k==s transposed einsum stays an einsum.
The convolution runs in the compute dtype and its output is rounded to it
before the cast back to the feature dtype, as in JAX.  Callers on the card
pin cuDNN's TF32 off (`utils.device.resolve_device`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .coords import SparseGrid
from .kernels import KernelSpec, RegionType

# "no-growth" dense routing, on by default as in the JAX package
DENSE_NO_GROWTH = True


def _dense_shape_ok(spec: KernelSpec, grid: SparseGrid) -> bool:
    if grid.extent is None or spec.transpose:
        return False
    if spec.region_type != RegionType.HYPER_CUBE:
        return False
    if any(s != 1 for s in spec.stride):
        return False
    return not any(k % 2 == 0 for k in spec.kernel_size)


def _cells_of(grid: SparseGrid) -> list:
    return [int(np.ceil(e / s)) for e, s in zip(grid.extent, grid.stride)]


def _total_cells(grid: SparseGrid) -> int:
    return grid.batch_size * int(np.prod(_cells_of(grid)))


def dense_no_growth_preferred(spec: KernelSpec, grid: SparseGrid) -> bool:
    """Same-grid conv whose dense cell count fits the sparse buffer."""
    if not DENSE_NO_GROWTH or not _dense_shape_ok(spec, grid):
        return False
    return _total_cells(grid) <= grid.capacity


def dense_no_growth_preferred2(spec: KernelSpec, in_grid: SparseGrid,
                               out_grid: SparseGrid) -> bool:
    """Strided or k==s transposed conv where densifying can grow neither
    buffer."""
    if not DENSE_NO_GROWTH:
        return False
    if in_grid.extent is None or out_grid.extent is None:
        return False
    if spec.region_type != RegionType.HYPER_CUBE:
        return False
    if spec.transpose:
        if any(k != s for k, s in zip(spec.kernel_size, spec.stride)):
            return False
        if any(d != 1 for d in spec.dilation):
            return False
    elif in_grid.ndim not in (2, 3):
        return False
    if _total_cells(in_grid) > in_grid.capacity:
        return False
    return _total_cells(out_grid) <= out_grid.capacity


def _flat_rows(grid: SparseGrid, cells):
    """(flat dense-cell index, in-range mask) per row."""
    flat = grid.coords[:, 0]
    ok = grid.valid
    for i, c in enumerate(cells):
        p = torch.div(grid.coords[:, 1 + i], grid.stride[i],
                      rounding_mode="floor")
        ok = ok & (p >= 0) & (p < c)
        flat = flat * c + p.clamp(0, c - 1)
    return flat, ok


def _densify(features: torch.Tensor, grid: SparseGrid, cells, cd):
    """[B, *cells, C] (channels last) from the valid rows."""
    total = grid.batch_size * int(np.prod(cells))
    flat, ok = _flat_rows(grid, cells)
    dest = torch.where(ok, flat, total).long()
    dense = torch.zeros((total + 1, features.shape[1]), dtype=cd,
                        device=features.device)
    dense[dest] = features.to(cd) * ok[:, None].to(cd)
    return dense[:total].reshape((grid.batch_size,) + tuple(cells) + (-1,))


def _gather_rows(out_dense: torch.Tensor, grid: SparseGrid, cells,
                 out_dtype, bias=None) -> torch.Tensor:
    """Rows of the dense (channels-last) result at the grid's coordinates."""
    flat, ok = _flat_rows(grid, cells)
    out_flat = out_dense.reshape(-1, out_dense.shape[-1])
    out = out_flat[torch.where(ok, flat, 0).long()] * ok[:, None].to(
        out_flat.dtype)
    out = out.to(out_dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _conv_nd(dense_cl: torch.Tensor, kernel: torch.Tensor, ks, cd,
             stride, dilation, pads) -> torch.Tensor:
    """Channels-last dense conv (cross-correlation, like `lax.conv`) with
    explicit per-axis (low, high) zero padding; returns channels last."""
    d = len(ks)
    cin, cout = kernel.shape[1], kernel.shape[2]
    x = dense_cl.movedim(-1, 1)  # [B, C, *spatial]
    flat_pad = []
    for lo, hi in reversed(pads):
        flat_pad += [lo, hi]
    x = F.pad(x, flat_pad)
    # (K, Cin, Cout) with C-order offsets → (Cout, Cin, *ks)
    w = kernel.reshape(tuple(ks) + (cin, cout)).to(cd)
    w = w.permute((d + 1, d) + tuple(range(d)))
    conv = F.conv3d if d == 3 else F.conv2d
    out = conv(x, w, stride=tuple(stride), dilation=tuple(dilation))
    return out.movedim(1, -1)


def dense_conv_apply(features: torch.Tensor, kernel: torch.Tensor,
                     grid: SparseGrid, spec: KernelSpec,
                     bias: torch.Tensor | None = None,
                     compute_dtype=None) -> torch.Tensor:
    """Stride-1 odd-kernel conv on one grid ("SAME" padding)."""
    cd = compute_dtype or features.dtype
    cells = _cells_of(grid)
    dense = _densify(features, grid, cells, cd)
    pads = [(lo * dl, lo * dl) for lo, dl in
            zip([(k - 1) // 2 for k in spec.kernel_size], spec.dilation)]
    out_d = _conv_nd(dense, kernel, spec.kernel_size, cd, (1,) * grid.ndim,
                     spec.dilation, pads)
    return _gather_rows(out_d, grid, cells, features.dtype, bias)


def dense_conv_general_apply(features: torch.Tensor, kernel: torch.Tensor,
                             in_grid: SparseGrid, out_grid: SparseGrid,
                             spec: KernelSpec,
                             bias: torch.Tensor | None = None,
                             compute_dtype=None) -> torch.Tensor:
    """Dense formulation of a strided or (k==s) transposed sparse conv.

    Transpose with k == s: each output cell has exactly one source —
    ``out[i·s + o] = in[i] @ W[o]`` — an einsum plus a spatial interleave."""
    d = in_grid.ndim
    cout = kernel.shape[2]
    cd = compute_dtype or features.dtype
    ci, co = _cells_of(in_grid), _cells_of(out_grid)
    dense = _densify(features, in_grid, ci, cd)
    ks = spec.kernel_size
    if spec.transpose:
        out_d = torch.einsum("...c,kcf->...kf", dense, kernel.to(cd))
        out_d = out_d.reshape(out_d.shape[:-2] + tuple(ks) + (cout,))
        # [b, x1..xd, k1..kd, f] -> [b, x1, k1, x2, k2, ..., f]
        perm = [0]
        for i in range(d):
            perm += [1 + i, 1 + d + i]
        perm += [1 + 2 * d]
        out_d = out_d.permute(perm).reshape(
            (in_grid.batch_size,) + tuple(c * k for c, k in zip(ci, ks)) +
            (cout,))
        out_d = out_d[(slice(None),) + tuple(slice(0, c) for c in co)]
    else:
        pads = []
        for i in range(d):
            p_lo = (ks[i] - 1) // 2 * spec.dilation[i]
            p_hi = ((co[i] - 1) * spec.stride[i] +
                    (ks[i] - 1) * spec.dilation[i] - p_lo - (ci[i] - 1))
            pads.append((p_lo, p_hi))
        out_d = _conv_nd(dense, kernel, ks, cd, spec.stride, spec.dilation,
                         pads)
    return _gather_rows(out_d, out_grid, co, features.dtype, bias)
