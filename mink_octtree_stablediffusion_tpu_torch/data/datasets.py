"""Datasets (host-side numpy): mesh files and synthetic shapes.

Port of `mink_octtree_stablediffusion_tpu/data/datasets.py`: the OFF and
OBJ readers; `ModelNet40Dataset` / `ShapeNetDataset` (per-class mesh
folders → area-uniform resampling within the point budget → scaling into
``[0, resolution)`` → voxels, with an npy cache, the 4-sample
``small_dataset`` mode, rotation augmentation and "a picture of a {class}"
captions); `ObjaverseDataset` (GLB files, optional image conditions); and
the parametric surfaces `SyntheticShapes` / `ProceduralShapes` (sphere /
torus / box / cylinder).  The same files, seed (and split) give the same
points and voxels as the JAX package: a mesh dataset draws its
resampling and its rotations from one shared ``RandomState`` in the order
of its ``__getitem__`` calls, and its cache files have the JAX package's
names, so either package reads a cache the other wrote.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np

from ..ops.coords import sparse_quantize_np
from .mesh import (load_glb, normalize_to_resolution, point_budget,
                   resample_mesh_count, rotate_point_cloud)


def load_off(path: str):
    """OFF mesh reader (ModelNet40's format); the counts may follow "OFF"
    on its own line ("OFF8 12 0")."""
    with open(path) as f:
        first = f.readline().strip()
        if first != "OFF":
            header = first[3:].split()
        else:
            header = f.readline().split()
        nv, nf = int(header[0]), int(header[1])
        verts = np.array([[float(x) for x in f.readline().split()[:3]]
                          for _ in range(nv)])
        faces = np.array([[int(x) for x in f.readline().split()[1:4]]
                          for _ in range(nf)])
    return verts, faces


def load_obj(path: str):
    """Wavefront OBJ reader (ShapeNet's format): ``v`` positions and
    fan-triangulated ``f`` faces (``v/vt/vn`` indices accepted, negative
    indices counted from the end)."""
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            if toks[0] == "v":
                verts.append([float(x) for x in toks[1:4]])
            elif toks[0] == "f":
                idx = [int(tok.split("/")[0]) for tok in toks[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, float),
            np.asarray(faces, int).reshape(-1, 3))


_MESH_LOADERS = {".off": load_off, ".obj": load_obj}


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


class ModelNet40Dataset:
    """``root/<class>/<phase>/*.{off,obj}`` → resampled, scaled points and
    their voxels (``{"coords", "xyz", "label"[, "caption"]}``).  With
    ``small_dataset`` every index reads one of the first 4 files."""

    def __init__(self, root: str, phase: str = "train",
                 resolution: int = 128, cache_dir: Optional[str] = None,
                 augment: bool = False, small_dataset: bool = False,
                 with_class: bool = False, seed: int = 0):
        self.root = root
        self.resolution = resolution
        self.augment = augment
        self.small_dataset = small_dataset
        self.with_class = with_class
        self.cache_dir = cache_dir
        self.rng = np.random.RandomState(seed)
        self.files: List[str] = []
        self.labels: List[int] = []
        self.classes: List[str] = []
        if os.path.isdir(root):
            self.classes = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d)))
            for li, c in enumerate(self.classes):
                d = os.path.join(root, c, phase)
                if os.path.isdir(d):
                    for f in sorted(os.listdir(d)):
                        if os.path.splitext(f)[1] in _MESH_LOADERS:
                            self.files.append(os.path.join(d, f))
                            self.labels.append(li)

    def __len__(self):
        return len(self.files)

    def cache_path(self, path: str) -> Optional[str]:
        """The npy cache of ``path``: keyed on the path relative to
        ``root``, since ShapeNet's dumps share file names across class
        folders."""
        if not self.cache_dir:
            return None
        rel = os.path.relpath(path, self.root)
        tag = hashlib.sha1(rel.encode()).hexdigest()[:16]
        return os.path.join(
            self.cache_dir,
            f"{os.path.basename(path)}.{tag}.r{self.resolution}.npy")

    def __getitem__(self, idx: int):
        if self.small_dataset:
            idx = idx % 4
        path = self.files[idx]
        cache = self.cache_path(path)
        if cache:
            os.makedirs(self.cache_dir, exist_ok=True)
        if cache and os.path.exists(cache):
            xyz = np.load(cache)
        else:
            verts, faces = _MESH_LOADERS[os.path.splitext(path)[1]](path)
            lo, hi = point_budget(self.resolution)
            n = min(max(lo * 2, 2 * self.resolution ** 2), hi)
            xyz = resample_mesh_count(verts, faces, n, self.rng)
            xyz = normalize_to_resolution(xyz, self.resolution)
            if cache:
                np.save(cache, xyz.astype(np.float32))
        if self.augment:
            xyz = rotate_point_cloud(xyz, self.rng)
            xyz = np.clip(xyz, 0, self.resolution - 1.01)
        out = {"coords": sparse_quantize_np(xyz, 1.0), "xyz": xyz,
               "label": self.labels[idx]}
        if self.with_class:
            out["caption"] = f"a picture of a {self.classes[self.labels[idx]]}"
        return out


class ShapeNetDataset(ModelNet40Dataset):
    """The same pipeline over per-class folders of ShapeNet OBJ dumps."""


class ObjaverseDataset:
    """Every ``*.glb`` under ``root`` (walked in order) → resampled,
    scaled points and their voxels, label 0, ``uid`` the file's stem; with
    ``image_dir``, ``image_dir/<uid>.npy`` (a preprocessed image condition)
    is loaded where it exists."""

    def __init__(self, root: str, resolution: int = 128,
                 image_dir: Optional[str] = None,
                 cache_dir: Optional[str] = None, seed: int = 0):
        self.root = root
        self.resolution = resolution
        self.image_dir = image_dir
        self.cache_dir = cache_dir
        self.rng = np.random.RandomState(seed)
        self.files: List[str] = []
        if os.path.isdir(root):
            for dirpath, _, names in os.walk(root):
                for n in sorted(names):
                    if n.endswith(".glb"):
                        self.files.append(os.path.join(dirpath, n))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        path = self.files[idx]
        uid = os.path.splitext(os.path.basename(path))[0]
        cache = None
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            cache = os.path.join(self.cache_dir,
                                 f"{uid}.r{self.resolution}.npy")
        if cache and os.path.exists(cache):
            xyz = np.load(cache)
        else:
            verts, faces = load_glb(path)
            lo, _ = point_budget(self.resolution)
            xyz = resample_mesh_count(verts, faces,
                                      max(lo, 2 * self.resolution ** 2),
                                      self.rng)
            xyz = normalize_to_resolution(xyz, self.resolution)
            if cache:
                np.save(cache, xyz.astype(np.float32))
        out = {"coords": sparse_quantize_np(xyz, 1.0), "xyz": xyz,
               "label": 0, "uid": uid}
        if self.image_dir:
            img = os.path.join(self.image_dir, f"{uid}.npy")
            if os.path.exists(img):
                out["image_cond"] = np.load(img)
        return out
