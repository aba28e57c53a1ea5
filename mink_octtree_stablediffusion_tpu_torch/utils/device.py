"""Device selection for the port's entry points.

Entry points (model constructors, ``serve.build_generate_fn``) run on the
card unless the caller asks for the CPU: ``device=None`` means ``cuda``, and
asking for ``cuda`` where PyTorch sees no card raises instead of silently
falling back to the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raise if CUDA is asked for and unavailable.

    On a CUDA device the float32 matmul and cuDNN convolution precision is
    pinned to full float32 (no TF32): the reference computes its float32
    products in float32, and cuDNN would otherwise default to TF32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    """A seeded ``torch.Generator`` living on ``device``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def stream_guard(dev: torch.device):
    """(PyTorch's current stream on the CUDA device ``dev`` as a raw
    handle, a context that makes ``dev`` the current device for a kernel
    launch); the context does nothing when ``dev`` already is current."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index is None or dev.index == torch.cuda.current_device():
        return stream, contextlib.nullcontext()
    return stream, torch.cuda.device(dev)
