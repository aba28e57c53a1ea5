"""Synthetic and procedural shapes (host-side numpy).

Port of `SyntheticShapes`, `ProceduralShapes` and `batch_iterator` from
`mink_octtree_stablediffusion_tpu/data/datasets.py` and
`normalize_to_resolution` from `data/mesh.py`: parametric surfaces (sphere /
torus / box / cylinder) voxelized like the mesh datasets.  The same seed
(and split) gives the same voxels as the JAX package.
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


class ProceduralShapes(SyntheticShapes):
    """Parameter-randomized surfaces with disjoint train/val/test splits:
    each sample's geometry is drawn from ``(seed, split, idx)`` through a
    SplitMix64-style hash (per-axis aspect, a random rotation, class
    parameters, and with probability ``composite_prob`` a union with a
    smaller same-class primitive at a random offset)."""

    _SPLIT_OFFSET = {"train": 0, "val": 1 << 24, "test": 1 << 25}

    @staticmethod
    def _mix_seed(seed: int, split_offset: int, idx: int) -> int:
        """SplitMix64-style hash of (seed, split, idx) → RandomState seed."""
        m = 1 << 64
        x = (seed * 0x9E3779B97F4A7C15 + split_offset * 0xBF58476D1CE4E5B9
             + idx * 0x94D049BB133111EB + 0xD6E8FEB86659FD93) % m
        x ^= x >> 30
        x = (x * 0xBF58476D1CE4E5B9) % m
        x ^= x >> 27
        x = (x * 0x94D049BB133111EB) % m
        x ^= x >> 31
        return int(x & 0x7FFFFFFF)

    def __init__(self, resolution: int = 64, num_samples: int = 512,
                 points_per_shape: int = 4096, seed: int = 0,
                 split: str = "train", composite_prob: float = 0.25,
                 with_class: bool = False):
        super().__init__(resolution, num_samples, points_per_shape, seed,
                         with_class)
        if split not in self._SPLIT_OFFSET:
            raise ValueError(f"split {split!r} not in "
                             f"{tuple(self._SPLIT_OFFSET)}")
        self.split = split
        self.composite_prob = composite_prob

    def _primitive(self, kind: str, n: int, rng) -> np.ndarray:
        u, v = rng.rand(n), rng.rand(n)
        if kind == "sphere":
            th, ph = 2 * np.pi * u, np.arccos(2 * v - 1)
            p = np.stack([np.sin(ph) * np.cos(th), np.sin(ph) * np.sin(th),
                          np.cos(ph)], -1)
        elif kind == "torus":
            r = rng.uniform(0.12, 0.42)
            R = 1.0 - r
            th, ph = 2 * np.pi * u, 2 * np.pi * v
            p = np.stack([(R + r * np.cos(ph)) * np.cos(th),
                          (R + r * np.cos(ph)) * np.sin(th),
                          r * np.sin(ph)], -1)
        elif kind == "cylinder":
            # closed tube: the points split by area between the side and
            # the two end caps at unit radius
            h = rng.uniform(0.5, 1.3)
            n_side = int(n * 2 * h / (2 * h + 1))
            th = 2 * np.pi * u
            side = np.stack([np.cos(th[:n_side]), np.sin(th[:n_side]),
                             h * (2 * v[:n_side] - 1)], -1)
            rr = np.sqrt(v[n_side:])
            sign = rng.randint(0, 2, n - n_side) * 2 - 1
            caps = np.stack([rr * np.cos(th[n_side:]),
                             rr * np.sin(th[n_side:]), sign * h], -1)
            p = np.concatenate([side, caps], 0)
        else:  # box: a random cuboid's surface, area-uniform over 6 faces
            half = rng.uniform(0.5, 1.0, 3)
            areas = np.array([half[1] * half[2], half[0] * half[2],
                              half[0] * half[1]])
            probs = np.repeat(areas / areas.sum() / 2.0, 2)
            face = rng.choice(6, n, p=probs)
            ax = face // 2
            sign = (face % 2) * 2 - 1
            p = rng.rand(n, 3) * 2 - 1
            p[np.arange(n), ax] = sign
            p = p * half[None, :]
        # per-axis aspect and a random rotation
        p = p * rng.uniform(0.55, 1.0, 3)[None, :]
        q, _ = np.linalg.qr(rng.randn(3, 3))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        return p @ q.T

    def __getitem__(self, idx: int):
        rng = np.random.RandomState(
            self._mix_seed(self.seed, self._SPLIT_OFFSET[self.split], idx))
        label = idx % len(self.CLASSES)
        kind = self.CLASSES[label]
        if rng.rand() < self.composite_prob:
            n1 = int(self.points * rng.uniform(0.6, 0.8))
            a = self._primitive(kind, n1, rng)
            b = self._primitive(kind, self.points - n1, rng)
            scale = rng.uniform(0.35, 0.65)
            direction = rng.randn(3)
            direction /= max(np.linalg.norm(direction), 1e-9)
            xyz = np.concatenate(
                [a, b * scale + direction[None, :] * rng.uniform(0.6, 1.0)],
                0)
        else:
            xyz = self._primitive(kind, self.points, rng)
        xyz = normalize_to_resolution(xyz, self.resolution)
        out = {"coords": sparse_quantize_np(xyz, 1.0), "xyz": xyz,
               "label": label}
        if self.with_class:
            out["caption"] = f"a picture of a {kind}"
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
