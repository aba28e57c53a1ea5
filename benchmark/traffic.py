"""The one traffic generator: a mix is a JSON file of parameters under
``benchmark/traffic/``, named by the cell's ``traffic``.

Two kinds of sample, both voxel sets on a bounded grid:

- ``shapes``: closed surfaces of the synthetic classes (sphere, torus,
  box, open cylinder), each sampled at ``points_per_area`` points a unit of
  area so that every voxel of its surface is hit, and sized to a voxel
  count drawn in ``[min_share, 1] · max_voxels``.
- ``rooms``: indoor scenes at 2 cm voxels: a floor sheet (label 0), two
  wall sheets with openings (label 1) and the top and side faces of
  furniture boxes (label 2), with colour-like features (the normalised
  coordinates plus N(0, 0.01²) noise), sized near ``room_voxels``.

The samples are drawn once from the mix's own ``pool_seed`` and dealt into
``batches`` batches (shapes: in draw order, a batch closed when the next
shape would pass ``max_batch_len``; rooms: ``per_batch`` a batch; a
request of the generation mix: ``per_batch`` shapes).  The run's seed
then moves every sample by a symmetry of the grid that keeps it inside
(axis swaps and flips; rooms keep their floor down), a shift by whole
voxels, and reorders the batches and the samples in each: every seed
gets the same voxel counts, so the same work, in another arrangement.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CLASSES = ("sphere", "torus", "box", "cylinder")
# surface area of each unit class shape (the sphere and cylinder of
# radius 1, the torus of radii 0.7 and 0.3, the box [-1, 1]³; the
# cylinder without its caps, height 2)
AREA = {"sphere": 4 * np.pi, "torus": 4 * np.pi ** 2 * 0.7 * 0.3,
        "box": 24.0, "cylinder": 4 * np.pi}


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


@dataclass
class Sample:
    coords: np.ndarray  # int32 [N, 3], distinct
    feats: np.ndarray = None  # float32 [N, C] (rooms)
    labels: np.ndarray = None  # int32 [N] (rooms)


def _surface(kind: str, n: int, rng) -> np.ndarray:
    u, v = rng.rand(n), rng.rand(n)
    if kind == "sphere":
        th, ph = 2 * np.pi * u, np.arccos(2 * v - 1)
        return np.stack([np.sin(ph) * np.cos(th), np.sin(ph) * np.sin(th),
                         np.cos(ph)], -1)
    if kind == "torus":
        th, ph = 2 * np.pi * u, 2 * np.pi * v
        return np.stack([(0.7 + 0.3 * np.cos(ph)) * np.cos(th),
                         (0.7 + 0.3 * np.cos(ph)) * np.sin(th),
                         0.3 * np.sin(ph)], -1)
    if kind == "cylinder":
        th = 2 * np.pi * u
        return np.stack([np.cos(th), np.sin(th), 2 * v - 1], -1)
    p = rng.rand(n, 3) * 2 - 1
    p[np.arange(n), rng.randint(0, 3, n)] = rng.randint(0, 2, n) * 2 - 1
    return p


def _unique_rows(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    lo = v.min(0)
    span = v.max(0) - lo + 1
    key = ((v[:, 0] - lo[0]) * span[1] + v[:, 1] - lo[1]) * span[2] + (
        v[:, 2] - lo[2])
    key = np.unique(key)
    z = key % span[2]
    y = key // span[2] % span[1]
    x = key // (span[1] * span[2])
    return np.stack([x + lo[0], y + lo[1], z + lo[2]], 1).astype(np.int32)


def _voxels(kind: str, radius: float, density: float, rng) -> np.ndarray:
    n = int(np.ceil(AREA[kind] * radius ** 2 * density))
    v = _unique_rows(np.floor(_surface(kind, n, rng) * radius))
    return v - v.min(0)


def shape(kind: str, target: int, res: int, density: float, rng
          ) -> np.ndarray:
    """A closed ``kind`` surface of about ``target`` voxels (never more),
    its corner at the origin, inside ``res``."""
    radius = min(np.sqrt(target / (1.4 * AREA[kind])), (res - 2) / 2)
    while True:
        v = _voxels(kind, radius, density, rng)
        if len(v) <= target and v.max() < res:
            return v
        radius *= 0.99 * np.sqrt(min(target / len(v), 1.0))


def room(rng, mix: dict) -> Sample:
    """One indoor scene, its corner at the origin (see the module)."""
    ext = mix["extent"]
    lo_w, hi_w = mix["footprint_voxels"]
    lo_h, hi_h = mix["height_voxels"]
    w, d = rng.randint(lo_w, hi_w + 1, 2)
    h = rng.randint(lo_h, hi_h + 1)
    parts, labels = [], []
    gx, gy = np.meshgrid(np.arange(w), np.arange(d), indexing="ij")
    parts.append(np.stack([gx.ravel(), gy.ravel(), np.zeros(w * d, int)], 1))
    labels.append(0)
    for axis, length in ((0, d), (1, w)):  # the walls at x = 0 and y = 0
        a, z = np.meshgrid(np.arange(length), np.arange(1, h),
                           indexing="ij")
        a, z = a.ravel(), z.ravel()
        door = rng.randint(0, max(length - 60, 1))
        win = rng.randint(0, max(length - 80, 1))
        keep = ~(((a >= door) & (a < door + 45) & (z < 105)) |
                 ((a >= win) & (a < win + 80) & (z > 50) & (z < 100)))
        a, z = a[keep], z[keep]
        zero = np.zeros(len(a), int)
        parts.append(np.stack([zero, a, z] if axis == 0 else [a, zero, z], 1))
        labels.append(1)
    count = sum(len(p) for p in parts)
    while count < mix["room_voxels"] * 0.95:
        sx, sy = rng.randint(20, 110, 2)
        sz = rng.randint(20, 100)
        x0 = rng.randint(2, max(w - sx - 2, 3))
        y0 = rng.randint(2, max(d - sy - 2, 3))
        box = []
        for fixed, (a_len, b_len), (ia, ib) in (
                (2, (sx, sy), (0, 1)), (0, (sy, sz), (1, 2)),
                (1, (sx, sz), (0, 2))):
            a, b = np.meshgrid(np.arange(a_len), np.arange(b_len),
                               indexing="ij")
            for side in ((sz,) if fixed == 2 else (0, (sx, sy)[fixed] - 1)):
                f = np.zeros((a.size, 3), int)
                f[:, ia], f[:, ib], f[:, fixed] = a.ravel(), b.ravel(), side
                box.append(f)
        box = np.concatenate(box) + [x0, y0, 1]
        box = box[(box < [w, d, h]).all(1)]
        parts.append(box)
        labels.append(2)
        count += len(box)
    lab = np.concatenate([np.full(len(p), lb, np.int32)
                          for p, lb in zip(parts, labels)])
    coords = np.concatenate(parts).astype(np.int64)
    key = (coords[:, 0] * ext + coords[:, 1]) * ext + coords[:, 2]
    _, first = np.unique(key, return_index=True)  # the first part wins
    first = np.sort(first)[:mix["room_voxels"]]
    return Sample(coords[first].astype(np.int32), labels=lab[first])


def _pool(mix: dict) -> List[List[Sample]]:
    rng = np.random.RandomState(mix["pool_seed"])
    batches = []
    if mix["sample"] == "rooms":
        for _ in range(mix["batches"]):
            batches.append([room(rng, mix) for _ in range(mix["per_batch"])])
        return batches
    res, cap = mix["resolution"], mix["max_voxels"]
    budget = mix.get("max_batch_len")
    for _ in range(mix["batches"]):
        batch, total = [], 0
        while True:
            kind = CLASSES[rng.randint(len(CLASSES))]
            target = int(cap * rng.uniform(mix["min_share"], 1.0))
            v = shape(kind, target, res, mix["points_per_area"], rng)
            if budget is not None and total + len(v) > budget:
                break
            batch.append(Sample(v))
            total += len(v)
            if len(batch) == mix.get("per_batch"):
                break
        batches.append(batch)
    return batches


def _moved(s: Sample, extent: int, rng, keep_floor: bool) -> Sample:
    c = s.coords
    perm = ([1, 0, 2] if rng.randint(2) else [0, 1, 2]) if keep_floor else \
        list(rng.permutation(3))
    c = c[:, perm]
    for ax in range(2 if keep_floor else 3):
        if rng.randint(2):
            c[:, ax] = c[:, ax].max() - c[:, ax]
    span = c.max(0) + 1
    shift = [rng.randint(0, max(extent - sp + 1, 1)) for sp in span]
    if keep_floor:
        shift[2] = 0
    return Sample((c + np.asarray(shift, np.int32)).astype(np.int32),
                  labels=s.labels)


def make_batches(mix: dict, seed: int) -> List[List[Sample]]:
    """The mix's batches for ``seed``: the pool's samples moved and
    reordered by the seed; rooms get their features drawn from it."""
    rng = np.random.RandomState(np.random.SeedSequence(
        [seed & 0xFFFFFFFF, seed >> 32]).generate_state(1)[0])
    extent = mix.get("extent", mix.get("resolution"))
    rooms = mix["sample"] == "rooms"
    out = []
    for bi in rng.permutation(mix["batches"]):
        batch = _pool_cached(mix)[bi]
        moved = [_moved(batch[i], extent, rng, rooms)
                 for i in rng.permutation(len(batch))]
        if rooms:
            for s in moved:
                s.feats = (s.coords / extent + rng.randn(len(s.coords), 3)
                           * 0.01).astype(np.float32)
        out.append(moved)
    return out


_POOLS: dict = {}


def _pool_cached(mix: dict):
    key = json.dumps(mix, sort_keys=True)
    if key not in _POOLS:
        _POOLS[key] = _pool(mix)
    return _POOLS[key]


def collate(batch: List[Sample], capacity: int) -> tuple:
    """(coords int32 [capacity, 4] with the batch column first, valid bool
    [capacity], feats float32 [capacity, C] (ones for shapes), labels int32
    [capacity], -1 off the data); padding rows hold 2^14 in every
    column, the program's padding coordinate."""
    rows = np.concatenate([np.concatenate(
        [np.full((len(s.coords), 1), b, np.int32), s.coords], 1)
        for b, s in enumerate(batch)])
    n = len(rows)
    if n > capacity:
        raise ValueError(f"batch of {n} voxels over capacity {capacity}")
    coords = np.full((capacity, 4), 1 << 14, np.int32)
    coords[:n] = rows
    valid = np.zeros(capacity, bool)
    valid[:n] = True
    if batch[0].feats is not None:
        feats = np.zeros((capacity, batch[0].feats.shape[1]), np.float32)
        feats[:n] = np.concatenate([s.feats for s in batch])
    else:
        feats = valid[:, None].astype(np.float32)
    labels = np.full(capacity, -1, np.int32)
    if batch[0].labels is not None:
        labels[:n] = np.concatenate([s.labels for s in batch])
    return coords, valid, feats, labels
