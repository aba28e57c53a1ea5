"""Device selection, CUDA builds, the flax → PyTorch weight bridge, the
import of reference checkpoints, diagnostics, gradient checks, profiling,
summaries and point-cloud renders."""

from . import cuda_build
from .convert import from_flax, load_flax
from .device import make_generator, resolve_device
from .diagnostics import (backend_differential_suite, backend_selfcheck,
                          get_device_memory_info, print_diagnostics)
from .gradcheck import gradcheck
from .profiling import Timer, synced_time, trace
from .summary import capacity_report, count_params, summary
from .torch_import import convert_module, load_torch_state_dict, strip_prefix
from .viz import render_pointclouds, sparse_tensor_clouds
