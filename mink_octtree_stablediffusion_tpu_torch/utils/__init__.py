"""Device selection, CUDA builds, the flax → PyTorch weight bridge,
point-cloud renders and the capacity report."""

from . import cuda_build
from .convert import from_flax, load_flax
from .device import make_generator, resolve_device
from .summary import capacity_report
from .viz import render_pointclouds, sparse_tensor_clouds
