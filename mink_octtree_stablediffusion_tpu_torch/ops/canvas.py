"""Dense latent canvas: a fully occupied coarse grid as the diffusion medium.

Port of `mink_octtree_stablediffusion_tpu/ops/canvas.py`.  A VAE latent is
scattered onto the full dense stride-``s`` grid (absent cells get zero
features, or noise where asked), the decoder's level-0 occupancy head
prunes the empty cells, and sampling starts from pure noise on a grid
that depends on no data (template-free generation).

The canvas rows are in (batch, x, y, z) row-major order, which is the
port's canonical order for bounded grids (`ops.coords.flat_cell_key`), so
the canvas is an ordinary bounded grid and nothing is sorted again.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .coords import SparseGrid
from .kernels import _tuplize
from .neighbors import grid_lookup


def canvas_grid(batch_size: int, resolution, stride, ndim: int = 3,
                device: DeviceLike = None) -> SparseGrid:
    """The full dense grid at tensor stride ``stride`` under a
    ``resolution`` extent (an int or one per dimension), every row valid,
    on ``device`` (default ``cuda``)."""
    res = _tuplize(resolution, ndim)
    sa = _tuplize(stride, ndim)
    cells = tuple(-(-r // s) for r, s in zip(res, sa))
    axes = [np.arange(c, dtype=np.int32) * s for c, s in zip(cells, sa)]
    mesh = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, ndim)
    n = len(mesh)
    coords = np.concatenate(
        [np.repeat(np.arange(batch_size, dtype=np.int32), n)[:, None],
         np.tile(mesh, (batch_size, 1))], axis=1)
    dev = resolve_device(device)
    return SparseGrid(coords=torch.as_tensor(coords, device=dev),
                      valid=torch.ones((batch_size * n,), dtype=torch.bool,
                                       device=dev),
                      stride=sa, batch_size=batch_size, extent=res)


def expand_to_canvas(latent, canvas: SparseGrid,
                     empty_noise_std: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None):
    """Scatter a sparse latent's features onto the dense ``canvas``: cells
    present in the latent keep their features, absent cells get zeros or,
    with ``empty_noise_std > 0``, N(0, std²) noise: ``std·noise`` where
    ``noise`` (N(0,1) draws, the canvas features' shape) is given, else a
    draw from ``generator`` (which must then be given)."""
    from ..tensor import SparseTensor

    idx = grid_lookup(latent.grid, canvas.coords, canvas.valid)
    present = (idx >= 0)[:, None]
    feats = torch.where(present, latent.features[idx.clamp(min=0).long()],
                        0.0)
    if empty_noise_std > 0.0:
        if noise is None:
            if generator is None:
                raise ValueError("empty_noise_std needs a generator")
            noise = torch.randn(feats.shape, generator=generator,
                                dtype=feats.dtype, device=feats.device)
        feats = torch.where(present, feats, empty_noise_std * noise)
    return SparseTensor(grid=canvas, features=feats)
