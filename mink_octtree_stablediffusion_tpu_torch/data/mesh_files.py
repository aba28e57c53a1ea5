"""Mesh files written from procedural meshes: the OFF, OBJ and GLB inputs
of the mesh datasets, made from a seed where no dataset is at hand (the
tests, `chip_smoke.py`'s data phase).

`torus_mesh` gives a closed triangle mesh of ``2·nu·nv`` faces;
`write_modelnet_tree` lays such meshes out as ModelNet40 does
(``root/<class>/<split>/<class>_<i>.off``).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional, Sequence

import numpy as np


def torus_mesh(nu: int, nv: int, big: float = 1.0, small: float = 0.35,
               scale: Sequence[float] = (1.0, 1.0, 1.0)):
    """A torus of ``nu × nv`` quads, each cut into two triangles →
    (vertices float64 [nu·nv, 3], faces int64 [2·nu·nv, 3])."""
    th, ph = np.meshgrid(2 * np.pi * np.arange(nu) / nu,
                         2 * np.pi * np.arange(nv) / nv, indexing="ij")
    verts = np.stack([(big + small * np.cos(ph)) * np.cos(th),
                      (big + small * np.cos(ph)) * np.sin(th),
                      small * np.sin(ph)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    c = ((i + 1) % nu) * nv + (j + 1) % nv
    d = i * nv + (j + 1) % nv
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    return verts * np.asarray(scale)[None, :], faces


def write_off(path: str, verts: np.ndarray, faces: np.ndarray,
              packed_header: bool = False) -> None:
    """OFF file; ``packed_header`` puts the counts on the "OFF" line."""
    counts = f"{len(verts)} {len(faces)} 0"
    head = f"OFF{counts}\n" if packed_header else f"OFF\n{counts}\n"
    with open(path, "w") as f:
        f.write(head)
        f.writelines(f"{x!r} {y!r} {z!r}\n" for x, y, z in verts.tolist())
        f.writelines(f"3 {a} {b} {c}\n" for a, b, c in faces.tolist())


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """OBJ file (1-based ``f`` indices)."""
    with open(path, "w") as f:
        f.writelines(f"v {x!r} {y!r} {z!r}\n" for x, y, z in verts.tolist())
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n"
                     for a, b, c in faces.tolist())


def write_glb(path: str, verts: np.ndarray, faces: np.ndarray,
              stride: Optional[int] = None) -> None:
    """GLB file of one triangle primitive (float32 positions, uint32
    indices); with ``stride`` (bytes, > 12) the positions are interleaved
    with padding, so a reader takes the strided accessor path."""
    pos = np.ascontiguousarray(verts, np.float32)
    idx = np.ascontiguousarray(faces, np.uint32).reshape(-1)
    if stride:
        rows = np.zeros((len(pos), stride), np.uint8)
        rows[:, :12] = pos.view(np.uint8).reshape(len(pos), 12)
        pos_bytes = rows.tobytes()
    else:
        pos_bytes = pos.tobytes()
    pad = (-len(pos_bytes)) % 4
    binary = pos_bytes + b"\0" * pad + idx.tobytes()
    view0 = {"buffer": 0, "byteOffset": 0, "byteLength": len(pos_bytes)}
    if stride:
        view0["byteStride"] = stride
    gltf = {"asset": {"version": "2.0"},
            "buffers": [{"byteLength": len(binary)}],
            "bufferViews": [view0, {"buffer": 0,
                                    "byteOffset": len(pos_bytes) + pad,
                                    "byteLength": idx.nbytes}],
            "accessors": [{"bufferView": 0, "componentType": 5126,
                           "count": len(pos), "type": "VEC3"},
                          {"bufferView": 1, "componentType": 5125,
                           "count": len(idx), "type": "SCALAR"}],
            "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                        "indices": 1, "mode": 4}]}]}
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    binary += b"\0" * ((-len(binary)) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2,
                            12 + 8 + len(js) + 8 + len(binary)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(binary), 0x004E4942) + binary)


def write_modelnet_tree(root: str, classes: Sequence[str], n_train: int,
                        n_test: int, nu: int = 100, nv: int = 50,
                        seed: int = 0, ext: str = ".off") -> list:
    """``root/<class>/{train,test}/<class>_<i><ext>`` tori of ``2·nu·nv``
    faces, each with its own tube radius and axis scales from ``seed``;
    returns the paths written."""
    rng = np.random.RandomState(seed)
    writer = {".off": write_off, ".obj": write_obj}[ext]
    paths = []
    for ci, c in enumerate(classes):
        for split, n in (("train", n_train), ("test", n_test)):
            d = os.path.join(root, c, split)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                v, f = torus_mesh(nu, nv, small=0.2 + 0.15 * ci +
                                  0.1 * rng.rand(),
                                  scale=rng.uniform(0.5, 1.5, 3))
                path = os.path.join(d, f"{c}_{i:04d}{ext}")
                writer(path, v, f)
                paths.append(path)
    return paths
