"""Device selection, CUDA builds, and the flax → PyTorch weight bridge."""

from . import cuda_build
from .convert import from_flax, load_flax
from .device import make_generator, resolve_device
