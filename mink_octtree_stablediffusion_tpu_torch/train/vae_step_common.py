"""The fixed VAE workload of the repository's VAE-step scripts.

Port of `scripts/bench_vae_step_common.py` (``shell_cloud``, ``make_batch``),
host numpy as there: sphere-shell point clouds voxelized at a resolution
(ModelNet40-like surface occupancy), batched and padded to a capacity.  The
same ``RandomState`` gives the same arrays bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..ops.coords import batched_coordinates_np, pad_to_capacity


def shell_cloud(rng: np.random.RandomState, n: int, res: int) -> np.ndarray:
    """Sphere-shell point cloud of ``n`` points at resolution ``res`` →
    its distinct voxels int32 [M, 3]."""
    p = rng.randn(n, 3)
    p /= np.linalg.norm(p, axis=1, keepdims=True) + 1e-9
    r = res / 2 - 1.51
    v = np.unique(((p * r) + res / 2).astype(np.int32), axis=0)
    return np.clip(v, 0, res - 1)


def make_batch(rng: np.random.RandomState, steps: int, b: int, cap: int,
               res: int, pts: int) -> tuple:
    """``steps`` distinct batches of ``b`` shells: coords int32 [steps,
    cap, 4] and valid bool [steps, cap]."""
    cs, vs = [], []
    for _ in range(steps):
        vox = [shell_cloud(rng, pts, res) for _ in range(b)]
        cpad, vpad = pad_to_capacity(batched_coordinates_np(vox), cap)
        cs.append(cpad)
        vs.append(vpad)
    return np.stack(cs), np.stack(vs)
