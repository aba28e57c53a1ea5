"""Kernel region definitions (static, host-side numpy).

Port of `mink_octtree_stablediffusion_tpu/ops/kernels.py`: per dimension the
offset set is ``(i - floor((k-1)/2)) * dilation * lattice_stride`` for
``i in range(k)`` — odd kernels are centred, even kernels cover [0, k)
(k=2 → {0, +1}: the octree children of the generative k2-s2 upsample).
HYPER_CUBE offsets enumerate in C order (first dimension slowest).
"""

from __future__ import annotations

import itertools
from enum import IntEnum
from typing import Sequence, Tuple

import numpy as np


class RegionType(IntEnum):
    HYPER_CUBE = 0
    HYPER_CROSS = 1
    CUSTOM = 2


def _tuplize(x, d: int) -> Tuple[int, ...]:
    if isinstance(x, (int, np.integer)):
        return (int(x),) * d
    t = tuple(int(v) for v in x)
    assert len(t) == d
    return t


def region_offsets(kernel_size, ndim: int,
                   region_type: RegionType = RegionType.HYPER_CUBE,
                   custom_offsets: np.ndarray | None = None) -> np.ndarray:
    """Unit lattice offsets [K, D] (before stride/dilation scaling)."""
    ks = _tuplize(kernel_size, ndim)
    if region_type == RegionType.CUSTOM:
        assert custom_offsets is not None and custom_offsets.shape[1] == ndim
        return np.asarray(custom_offsets, dtype=np.int32)
    lows = [int(np.floor((k - 1) / 2)) for k in ks]
    if region_type == RegionType.HYPER_CUBE:
        axes = [np.arange(k) - lo for k, lo in zip(ks, lows)]
        return np.array(list(itertools.product(*axes)), dtype=np.int32)
    if region_type == RegionType.HYPER_CROSS:
        assert all(k % 2 == 1 for k in ks), "HYPER_CROSS requires odd kernel sizes"
        offs = [np.zeros(ndim, dtype=np.int32)]
        for d, (k, lo) in enumerate(zip(ks, lows)):
            for i in range(k):
                if i - lo == 0:
                    continue
                o = np.zeros(ndim, dtype=np.int32)
                o[d] = i - lo
                offs.append(o)
        return np.stack(offs).astype(np.int32)
    raise NotImplementedError(region_type)


class KernelSpec:
    """Static description of one sparse conv kernel application."""

    def __init__(self, kernel_size, stride=1, dilation=1, ndim: int = 3,
                 region_type: RegionType = RegionType.HYPER_CUBE,
                 custom_offsets: np.ndarray | None = None,
                 transpose: bool = False):
        self.ndim = ndim
        self.kernel_size = _tuplize(kernel_size, ndim)
        self.stride = _tuplize(stride, ndim)
        self.dilation = _tuplize(dilation, ndim)
        self.region_type = region_type
        self.transpose = transpose
        self.offsets = region_offsets(self.kernel_size, ndim, region_type,
                                      custom_offsets)

    @property
    def volume(self) -> int:
        return int(self.offsets.shape[0])

    def out_stride(self, in_stride: Sequence[int]) -> Tuple[int, ...]:
        if self.transpose:
            out = []
            for ts, s in zip(in_stride, self.stride):
                assert ts % s == 0, f"transpose stride {s} must divide tensor stride {ts}"
                out.append(ts // s)
            return tuple(out)
        return tuple(ts * s for ts, s in zip(in_stride, self.stride))

    def absolute_offsets(self, in_stride: Sequence[int]) -> np.ndarray:
        """Offsets scaled to lattice units [K, D]: conv units are
        ``in_stride·dilation``, transpose units ``out_stride·dilation``."""
        if self.transpose:
            unit = np.array(self.out_stride(in_stride), dtype=np.int32)
        else:
            unit = np.array(in_stride, dtype=np.int32)
        unit = unit * np.array(self.dilation, dtype=np.int32)
        return self.offsets * unit[None, :]

    @property
    def is_identity(self) -> bool:
        """Kernel volume 1 and stride 1 → a plain feature matmul."""
        return self.volume == 1 and all(s == 1 for s in self.stride)
