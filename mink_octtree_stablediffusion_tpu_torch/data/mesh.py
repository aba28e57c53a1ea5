"""Mesh → point-cloud sampling (host-side numpy).

Port of `mink_octtree_stablediffusion_tpu/data/mesh.py`: area-weighted
barycentric face sampling over ``(vertices, faces)`` arrays, the scaling
into ``[0, resolution)``, the per-resolution point budget, the random
rotation augmentation, and a minimal GLB (glTF binary) reader.  Given the
same ``np.random.RandomState``, every function draws the same numbers in
the same order as the JAX package's and returns the same array bit for
bit.
"""

from __future__ import annotations

import json
import struct

import numpy as np


def face_areas(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)


def _sample_faces(vertices, faces, n, probs, rng) -> np.ndarray:
    counts = rng.multinomial(n, probs)
    face_idx = np.repeat(np.arange(len(faces)), counts)
    r1 = np.sqrt(rng.rand(len(face_idx), 1))
    r2 = rng.rand(len(face_idx), 1)
    a, b, c = (vertices[faces[face_idx, i]] for i in range(3))
    return (1 - r1) * a + r1 * (1 - r2) * b + r1 * r2 * c


def resample_mesh(vertices: np.ndarray, faces: np.ndarray,
                  density: float = 1.0,
                  rng: np.random.RandomState | None = None) -> np.ndarray:
    """Sample ~``density`` points per unit area."""
    rng = rng or np.random.RandomState()
    areas = face_areas(vertices, faces)
    n_total = max(int(areas.sum() * density), 1)
    probs = areas / max(areas.sum(), 1e-12)
    return _sample_faces(vertices, faces, n_total, probs, rng)


def resample_mesh_count(vertices: np.ndarray, faces: np.ndarray, n: int,
                        rng: np.random.RandomState | None = None
                        ) -> np.ndarray:
    """Sample exactly ``n`` points, uniform over the surface's area."""
    rng = rng or np.random.RandomState()
    areas = face_areas(vertices, faces)
    probs = areas / max(areas.sum(), 1e-12)
    return _sample_faces(vertices, faces, n, probs, rng)


def normalize_to_resolution(xyz: np.ndarray, resolution: int) -> np.ndarray:
    """Scale/shift a cloud into [0, resolution)."""
    lo, hi = xyz.min(0), xyz.max(0)
    scale = (resolution - 1.01) / max((hi - lo).max(), 1e-9)
    return (xyz - lo) * scale


def point_budget(resolution: int) -> tuple[int, int]:
    """(min, max) point counts of a resampled mesh at ``resolution``."""
    return (int(resolution ** 1.25 + 1000), int(resolution ** 2.4 + 50000))


def _axis_rotation(theta: float, u) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    x, y, z = u
    return np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s,
         x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c),
         y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
         c + z * z * (1 - c)],
    ])


def rotate_point_cloud(xyz: np.ndarray, rng: np.random.RandomState,
                       axis: str = "all") -> np.ndarray:
    """Rotate about the cloud's centre: about z only (``axis="z"``), else
    about x, then y, then z by three uniform angles (drawn in that
    order)."""
    if axis == "z":
        m = _axis_rotation(rng.uniform(0, 2 * np.pi), (0, 0, 1))
    else:
        m = (_axis_rotation(rng.uniform(0, 2 * np.pi), (1, 0, 0))
             @ _axis_rotation(rng.uniform(0, 2 * np.pi), (0, 1, 0))
             @ _axis_rotation(rng.uniform(0, 2 * np.pi), (0, 0, 1)))
    center = xyz.mean(0)
    return (xyz - center) @ m.T + center


_GLB_MAGIC, _CHUNK_JSON, _CHUNK_BIN = 0x46546C67, 0x4E4F534A, 0x004E4942
_COMPONENTS = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
               5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_WIDTHS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


def load_glb(path: str):
    """Positions and triangle indices of every triangle primitive of a GLB
    file, concatenated (``(vertices float64 [V, 3], faces int64 [F, 3])``).
    Chunks are padded to 4 bytes; an accessor may be strided."""
    with open(path, "rb") as f:
        magic, _version, _length = struct.unpack("<III", f.read(12))
        if magic != _GLB_MAGIC:
            raise ValueError(f"{path} is not a GLB file")
        data = f.read()
    off, gltf, bin_buf = 0, None, None
    while off < len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8: off + 8 + clen]
        if ctype == _CHUNK_JSON:
            gltf = json.loads(chunk.decode("utf-8"))
        elif ctype == _CHUNK_BIN:
            bin_buf = chunk
        off += 8 + clen + (-clen) % 4

    def read_accessor(idx):
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        comp = _COMPONENTS[acc["componentType"]]
        ncomp = _WIDTHS[acc["type"]]
        count = acc["count"]
        stride = view.get("byteStride")
        if stride and stride != np.dtype(comp).itemsize * ncomp:
            return np.stack([np.frombuffer(bin_buf, comp, ncomp,
                                           start + i * stride)
                             for i in range(count)])
        return np.frombuffer(bin_buf, comp, count * ncomp, start).reshape(
            count, ncomp)

    verts_all, faces_all, base = [], [], 0
    for mesh in gltf.get("meshes", []):
        for prim in mesh.get("primitives", []):
            if "POSITION" not in prim.get("attributes", {}):
                continue
            v = read_accessor(prim["attributes"]["POSITION"]).astype(
                np.float64)
            if "indices" in prim:
                idx = read_accessor(prim["indices"]).reshape(-1).astype(
                    np.int64)
            else:
                idx = np.arange(len(v), dtype=np.int64)
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            verts_all.append(v)
            faces_all.append(idx.reshape(-1, 3) + base)
            base += len(v)
    if not verts_all:
        raise ValueError(f"no triangle meshes in {path}")
    return np.concatenate(verts_all), np.concatenate(faces_all)
