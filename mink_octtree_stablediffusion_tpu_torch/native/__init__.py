"""Native host-side kernels (C++ through ctypes) for the data pipeline.

Port of `mink_octtree_stablediffusion_tpu/native/`: voxelization with
first-occurrence dedup, label consensus, Morton codes and fused batch
collation, on the host, where the device is fed.  The library
(``voxelize.cpp``, the port's own copy) is built at first use with the
host's C++ compiler into the package's ``_build/`` (`native.build`) and
loaded with ctypes.  Where the host has no compiler every function takes
its plain path (numpy, and a Python loop for the label consensus), as the
JAX package's do when its library is missing; the tests hold the C++
equal to the plain paths.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from . import build as _build

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
    ptr = np.ctypeslib.ndpointer
    lib.voxelize_unique.restype = i64
    lib.voxelize_unique.argtypes = [
        ptr(np.float32, flags="C"), i64, i32, f32,
        ptr(np.int32, flags="C,W"), ptr(np.int32, flags="C,W")]
    lib.unique_coords.restype = i64
    lib.unique_coords.argtypes = [
        ptr(np.int32, flags="C"), i64, i32,
        ptr(np.int32, flags="C,W"), ptr(np.int32, flags="C,W")]
    lib.unique_coords_label.restype = i64
    lib.unique_coords_label.argtypes = [
        ptr(np.int32, flags="C"), ptr(np.int32, flags="C"), i64, i32, i32,
        ptr(np.int32, flags="C,W"), ptr(np.int32, flags="C,W"),
        ptr(np.int32, flags="C,W")]
    lib.morton_codes.restype = None
    lib.morton_codes.argtypes = [
        ptr(np.int32, flags="C"), i64, i32, i32, ptr(np.int32, flags="C,W")]
    lib.collate_batch.restype = i64
    lib.collate_batch.argtypes = [
        ptr(np.float32, flags="C"), ptr(np.int64, flags="C"), i32, i32, f32,
        i64, i32, ptr(np.int32, flags="C,W"), ptr(np.uint8, flags="C,W")]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded at first use; None without a
    compiler."""
    global _lib, _tried
    with _lock:
        if not _tried:
            path = _build.build()
            _lib = None if path is None else _bind(ctypes.CDLL(str(path)))
            _tried = True
    return _lib


def available() -> bool:
    """True where the C++ library is built and loaded."""
    return _load() is not None


def _check_points(a: np.ndarray, dtype) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype)
    if a.ndim != 2:
        raise ValueError(f"expected a [n, d] array, got shape {a.shape}")
    return a


def sparse_quantize(points: np.ndarray, quantization_size: float = 1.0,
                    return_inverse: bool = False):
    """Voxelize (floor of ``points / quantization_size``) and dedup, the
    first occurrence first → coords [m, d] int32 (and inverse [n] int32:
    input row → voxel)."""
    lib = _load()
    pts = _check_points(points, np.float32)
    n, d = pts.shape
    if lib is None:
        from ..ops.coords import sparse_quantize_np

        return sparse_quantize_np(pts, quantization_size,
                                  return_inverse=return_inverse)
    out_coords = np.empty((n, d), np.int32)
    inverse = np.empty((n,), np.int32)
    nu = lib.voxelize_unique(pts, n, d, float(quantization_size), out_coords,
                             inverse)
    coords = out_coords[:nu].copy()
    return (coords, inverse) if return_inverse else coords


def quantize_label_plain(coords: np.ndarray, labels: np.ndarray,
                         invalid_label: int = -100):
    """The label consensus as a loop: unique coords in first-occurrence
    order, each with its first point's label, or ``invalid_label`` once
    two of its points disagree; and the inverse map."""
    index = {}
    out_coords, out_labels = [], []
    inverse = np.empty((len(coords),), np.int32)
    for i, (c, lab) in enumerate(zip(coords.tolist(), labels.tolist())):
        key = tuple(c)
        u = index.get(key)
        if u is None:
            u = index[key] = len(out_coords)
            out_coords.append(c)
            out_labels.append(lab)
        elif out_labels[u] != lab:
            out_labels[u] = invalid_label
        inverse[i] = u
    d = coords.shape[1]
    return (np.asarray(out_coords, np.int32).reshape(-1, d),
            np.asarray(out_labels, np.int32), inverse)


def quantize_label(coords: np.ndarray, labels: np.ndarray,
                   invalid_label: int = -100):
    """Label-consensus unique of integer coords (reference
    `utils/quantization.py:96-122`) → (coords, labels, inverse)."""
    lib = _load()
    c = _check_points(coords, np.int32)
    lab = np.ascontiguousarray(labels, np.int32)
    if lab.shape != (len(c),):
        raise ValueError(f"labels of shape {lab.shape} for {len(c)} points")
    if lib is None:
        return quantize_label_plain(c, lab, invalid_label)
    n, d = c.shape
    out_coords = np.empty((n, d), np.int32)
    out_labels = np.empty((n,), np.int32)
    inverse = np.empty((n,), np.int32)
    nu = lib.unique_coords_label(c, lab, n, d, invalid_label, out_coords,
                                 out_labels, inverse)
    return out_coords[:nu].copy(), out_labels[:nu].copy(), inverse


def morton_codes(xyz: np.ndarray, stride: int = 1) -> np.ndarray:
    """`ops.morton.morton_encode_np`, bit for bit."""
    lib = _load()
    x = _check_points(xyz, np.int32)
    if lib is None:
        from ..ops.morton import morton_encode_np

        return morton_encode_np(x, stride)
    n, d = x.shape
    out = np.empty((n,), np.int32)
    lib.morton_codes(x, n, d, int(stride), out)
    return out


def collate_batch(point_list, quantization_size: float, capacity: int,
                  pad_value: int) -> Tuple[np.ndarray, np.ndarray]:
    """Voxelize, dedup, batch-index and pad B clouds into one buffer →
    (coords [capacity, 1+d] int32, padding rows ``pad_value``; valid
    [capacity] bool)."""
    lib = _load()
    if lib is None:
        from ..ops.coords import batched_coordinates_np, sparse_quantize_np

        vox = [sparse_quantize_np(np.asarray(p, np.float32),
                                  quantization_size) for p in point_list]
        rows = batched_coordinates_np(vox)[:capacity]
        coords = np.full((capacity, rows.shape[1]), pad_value, np.int32)
        coords[:len(rows)] = rows
        valid = np.zeros((capacity,), bool)
        valid[:len(rows)] = True
        return coords, valid
    pts = _check_points(np.concatenate(point_list, 0), np.float32)
    offsets = np.zeros(len(point_list) + 1, np.int64)
    np.cumsum([len(p) for p in point_list], out=offsets[1:])
    d = pts.shape[1]
    out_coords = np.empty((capacity, d + 1), np.int32)
    out_valid = np.empty((capacity,), np.uint8)
    lib.collate_batch(pts, offsets, len(point_list), d,
                      float(quantization_size), capacity, pad_value,
                      out_coords, out_valid)
    return out_coords, out_valid.astype(bool)
