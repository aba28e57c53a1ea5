"""Activations (port of `nn/act.py::get_act` for the names the models use)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

_ACTS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "elu": F.elu,
    "silu": F.silu,
    "swish": F.silu,
}


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in _ACTS:
        raise NotImplementedError(f"activation {name!r} is not ported yet")
    return _ACTS[name]
