"""Global engine switches.

Port of `mink_octtree_stablediffusion_tpu/config.py`: the reference's
``MinkowskiAlgorithm`` DEFAULT / MEMORY_EFFICIENT / SPEED_OPTIMIZED become
two knobs, the dense-LUT size ceiling of coordinate queries
(``ops.lut.LUT_MAX_ENTRIES``) and the size up to which the plain conv
gathers all offsets for one GEMM (``ops.conv.DEFAULT_FUSED_THRESHOLD``).
"""

from __future__ import annotations

from enum import Enum

from .ops import conv as _conv
from .ops import lut as _lut


class Algorithm(Enum):
    DEFAULT = "default"
    MEMORY_EFFICIENT = "memory"
    SPEED_OPTIMIZED = "speed"


_DEFAULTS = {
    Algorithm.DEFAULT: dict(lut_max_entries=2_097_152,
                            fused_threshold=1 << 21),
    # smaller LUTs and the per-offset conv loop: lower peak memory
    Algorithm.MEMORY_EFFICIENT: dict(lut_max_entries=262_144,
                                     fused_threshold=1 << 18),
    # bigger LUTs and the one-GEMM gather: fastest
    Algorithm.SPEED_OPTIMIZED: dict(lut_max_entries=16_777_216,
                                    fused_threshold=1 << 26),
}

_current = Algorithm.DEFAULT


def set_algorithm(mode) -> None:
    """Switch the trade-off profile for every later call (an
    ``Algorithm`` or its value)."""
    global _current
    mode = mode if isinstance(mode, Algorithm) else Algorithm(mode)
    cfg = _DEFAULTS[mode]
    _lut.LUT_MAX_ENTRIES = cfg["lut_max_entries"]
    _conv.DEFAULT_FUSED_THRESHOLD = cfg["fused_threshold"]
    _current = mode


def get_algorithm() -> Algorithm:
    return _current
