"""Device selection, CUDA builds, the flax → PyTorch weight bridge, and
point-cloud renders."""

from . import cuda_build
from .convert import from_flax, load_flax
from .device import make_generator, resolve_device
from .viz import render_pointclouds, sparse_tensor_clouds
