"""Dense layer with the JAX package's default initialisation.

A flax ``nn.Dense`` keeps its kernel as ``[in, out]``; the port uses
``torch.nn.Linear`` (``weight [out, in]``).  Initialisation is LeCun normal
(std ``1/sqrt(in)``) with a zero bias, drawn from an explicit generator.
Parameters stored in another dtype than the input's (bf16 storage,
``train.optim.cast_params``) are widened to the input's dtype, as flax's
``Dense`` promotes them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.in_features),
                                generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias
        return F.linear(x, self.weight.to(x.dtype),
                        None if b is None else b.to(x.dtype))
