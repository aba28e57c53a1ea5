"""Initialise every parameter of a model from one explicit generator."""

from __future__ import annotations

import torch
from torch import nn


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw all parameters in module order: conv kernels kaiming-normal
    over K·Cin, dense weights LeCun-normal, biases zero, norm scales one."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator=generator)
