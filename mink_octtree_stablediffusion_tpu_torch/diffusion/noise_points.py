"""Latent noise-point injection.

Port of `mink_octtree_stablediffusion_tpu/diffusion/noise_points.py`:
extra latent coordinates with zero (or noise) features are unioned into
the encoded latent (`ops.union`), so that diffusion learns to denoise
occupancy as well as features.  Modes:

- ``uniform``: ``noise_point_max`` random latent-lattice cells per
  instance (drawn by ``uniform_points``, from a ``torch.Generator``);
- ``all``: the full latent grid;
- ``noise_near`` (with either mode, or alone): the k3-s1 neighbours of
  every occupied latent cell, with zero features or, given
  ``near_sigma``, N(0, near_sigma²) features.

The union lives in a fixed ``capacity`` buffer.  On an unbounded latent
the near grid and the union are unbounded, in (batch, Morton) order, row
for row the JAX package's.  On a bounded latent the port keeps the
extent, so that the union stays bounded and its convs on the fused
route: the neighbours outside the extent are dropped, where the JAX
package keeps them on an unbounded grid; inside the extent the two agree
cell for cell while the buffers do not overflow.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.coords import (INVALID_COORD, SparseGrid, device_const,
                          expand_grid, make_grid, unique_coords)
from ..ops.kernels import KernelSpec
from ..ops.union import union
from ..tensor import SparseTensor


def uniform_points(generator: Optional[torch.Generator], batch_size: int,
                   num_points: int, latent_resolution: int, ndim: int = 3,
                   device=None) -> torch.Tensor:
    """The ``uniform`` mode's draw: int32 [batch_size·num_points, ndim]
    lattice positions in [0, latent_resolution)."""
    return torch.randint(0, latent_resolution,
                         (batch_size * num_points, ndim),
                         generator=generator, device=device,
                         dtype=torch.int32)


def _uniform_grid(points: torch.Tensor, latent: SparseTensor) -> SparseGrid:
    b = latent.batch_size
    s = int(latent.tensor_stride[0])
    n = points.shape[0]
    batch = torch.arange(b, dtype=torch.int32, device=points.device
                         ).repeat_interleave(n // b)
    coords = torch.cat([batch[:, None], (points * s).to(torch.int32)], 1)
    grid, _, _ = make_grid(coords, torch.ones(n, dtype=torch.bool,
                                              device=points.device),
                           n, latent.tensor_stride, b,
                           extent=latent.grid.extent)
    return grid


def _all_grid(latent: SparseTensor, latent_resolution: int) -> SparseGrid:
    b = latent.batch_size
    s = int(latent.tensor_stride[0])
    d = latent.grid.ndim
    axes = np.arange(latent_resolution, dtype=np.int32) * s
    mesh = np.stack(np.meshgrid(*([axes] * d), indexing="ij"),
                    axis=-1).reshape(-1, d)
    n = len(mesh)
    coords = np.concatenate(
        [np.repeat(np.arange(b, dtype=np.int32), n)[:, None],
         np.tile(mesh, (b, 1))], axis=1)
    dev = latent.features.device
    grid, _, _ = make_grid(torch.as_tensor(coords, device=dev),
                           torch.ones(b * n, dtype=torch.bool, device=dev),
                           b * n, latent.tensor_stride, b,
                           extent=latent.grid.extent)
    return grid


def _near_grid(latent: SparseTensor, capacity: int) -> SparseGrid:
    """Every occupied cell and its k3-s1 neighbours: all of them on an
    unbounded latent (JAX's ``expand_grid``), those inside the extent on a
    bounded one."""
    g = latent.grid
    offs = KernelSpec(3, 1, ndim=g.ndim).absolute_offsets(g.stride)
    if g.extent is None:
        return expand_grid(g, offs, g.stride, capacity)
    k = offs.shape[0]
    off = device_const(offs, torch.int32, g.device)
    cand = torch.cat([g.coords[:, None, :1].expand(g.capacity, k, 1),
                      g.coords[:, None, 1:] + off[None]], -1).reshape(
        -1, 1 + g.ndim)
    valid = g.valid.repeat_interleave(k)
    cand = cand.masked_fill(~valid[:, None], INVALID_COORD)
    uc, uv, _, _ = unique_coords(cand, valid, capacity, g.stride,
                                 extent=g.extent, with_inverse=False)
    return SparseGrid(coords=uc, valid=uv, stride=g.stride,
                      batch_size=g.batch_size, extent=g.extent)


def inject_noise_points(latent: SparseTensor, mode: str = "uniform",
                        latent_resolution: int = 16,
                        noise_point_max: int = 64,
                        capacity: Optional[int] = None,
                        noise_near: bool = False,
                        near_sigma=None,
                        generator: Optional[torch.Generator] = None,
                        points: Optional[torch.Tensor] = None,
                        near_noise: Optional[torch.Tensor] = None
                        ) -> SparseTensor:
    """Union noise-point coordinates (zero or noise features) into the
    latent.  The draws can be passed in: ``points`` (``uniform_points``'
    shape) for the ``uniform`` mode, ``near_noise`` (N(0,1), one row per
    row of the near grid's ``capacity`` buffer) for ``near_sigma``;
    otherwise they come from ``generator``."""
    if mode not in ("none", "uniform", "all"):
        raise ValueError(f"noise_point_mode {mode!r}")
    if mode == "none" and not noise_near:
        return latent
    cap = capacity or latent.capacity
    grids, feats = [latent.grid], [latent.features]
    c, dt = latent.num_channels, latent.features.dtype
    dev = latent.features.device
    if mode == "uniform":
        if points is None:
            points = uniform_points(generator, latent.batch_size,
                                    noise_point_max, latent_resolution,
                                    latent.grid.ndim, dev)
        grids.append(_uniform_grid(points, latent))
    elif mode == "all":
        grids.append(_all_grid(latent, latent_resolution))
    if mode != "none":
        feats.append(torch.zeros((grids[-1].capacity, c), dtype=dt,
                                 device=dev))
    if noise_near:
        g = _near_grid(latent, cap)
        f = torch.zeros((g.capacity, c), dtype=dt, device=dev)
        if near_sigma is not None:
            if near_noise is None:
                near_noise = torch.randn(f.shape, generator=generator,
                                         dtype=dt, device=dev)
            f = near_sigma * near_noise * g.valid[:, None].to(dt)
        grids.append(g)
        feats.append(f)
    grid, out = union(grids, feats, cap)
    return SparseTensor(grid=grid, features=out).mask_features()
