"""Synthetic shapes (host-side numpy).

Port of `SyntheticShapes` and `batch_iterator` from
`mink_octtree_stablediffusion_tpu/data/datasets.py` and
`normalize_to_resolution` from `data/mesh.py`: parametric surfaces (sphere /
torus / box / cylinder) voxelized like the mesh datasets.  The same seed
gives the same voxels as the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..ops.coords import sparse_quantize_np


def normalize_to_resolution(xyz: np.ndarray, resolution: int) -> np.ndarray:
    """Scale/shift a cloud into [0, resolution)."""
    lo, hi = xyz.min(0), xyz.max(0)
    scale = (resolution - 1.01) / max((hi - lo).max(), 1e-9)
    return (xyz - lo) * scale


class SyntheticShapes:

    CLASSES = ("sphere", "torus", "box", "cylinder")

    def __init__(self, resolution: int = 64, num_samples: int = 64,
                 points_per_shape: int = 4096, seed: int = 0,
                 with_class: bool = False):
        self.resolution = resolution
        self.num_samples = num_samples
        self.points = points_per_shape
        self.seed = seed
        self.with_class = with_class

    def __len__(self):
        return self.num_samples

    def _surface(self, kind: str, n: int, rng) -> np.ndarray:
        u, v = rng.rand(n), rng.rand(n)
        if kind == "sphere":
            th, ph = 2 * np.pi * u, np.arccos(2 * v - 1)
            return np.stack([np.sin(ph) * np.cos(th),
                             np.sin(ph) * np.sin(th), np.cos(ph)], -1)
        if kind == "torus":
            th, ph = 2 * np.pi * u, 2 * np.pi * v
            r, R = 0.3, 0.7
            return np.stack([(R + r * np.cos(ph)) * np.cos(th),
                             (R + r * np.cos(ph)) * np.sin(th),
                             r * np.sin(ph)], -1)
        if kind == "cylinder":
            th, z = 2 * np.pi * u, 2 * v - 1
            return np.stack([np.cos(th), np.sin(th), z], -1)
        # box: project random points to faces
        p = rng.rand(n, 3) * 2 - 1
        ax = rng.randint(0, 3, n)
        sign = rng.randint(0, 2, n) * 2 - 1
        p[np.arange(n), ax] = sign
        return p

    def __getitem__(self, idx: int):
        rng = np.random.RandomState(self.seed + idx)
        label = idx % len(self.CLASSES)
        xyz = self._surface(self.CLASSES[label], self.points, rng)
        xyz = normalize_to_resolution(xyz, self.resolution)
        out = {"coords": sparse_quantize_np(xyz, 1.0), "xyz": xyz,
               "label": label}
        if self.with_class:
            out["caption"] = f"a picture of a {self.CLASSES[label]}"
        return out


def batch_iterator(dataset, batch_size: int, rng: np.random.RandomState,
                   shuffle: bool = True):
    """Minimal epoch iterator yielding lists of samples (a ragged tail is
    dropped)."""
    idx = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(idx)
    for i in range(0, len(idx) - batch_size + 1, batch_size):
        yield [dataset[int(j)] for j in idx[i:i + batch_size]]
