"""Dense layers with the JAX package's default initialisation: `Dense`
on a plain tensor, `Linear` (the reference's ``MinkowskiLinear``, JAX
`nn/conv.py:288-298`) on a sparse tensor's or a field's features.

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

from ..parallel.tp import copy_to_model, gather_from_model


class Dense(nn.Linear):
    """Tensor-parallel once ``parallel.shard_model_params`` has sharded
    its ``weight`` (``model_shard``): this rank's ``[out/n, in]`` rows on
    ``copy_to_model(x)``, ``gather_from_model``, then the whole bias."""

    tp_weight = "weight"
    model_shard = None

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.in_features),
                                generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias
        tp = self.model_shard
        if tp is None:
            return F.linear(x, self.weight.to(x.dtype),
                            None if b is None else b.to(x.dtype))
        y = gather_from_model(F.linear(copy_to_model(x, tp),
                                       self.weight.to(x.dtype)), tp)
        return y if b is None else y + b.to(x.dtype)


class Linear(nn.Module):
    """1x1 feature transform of a ``SparseTensor`` or ``TensorField``
    (its dense layer ``fc``, flax's auto-named ``Dense_0``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.fc = Dense(in_channels, out_channels, bias=use_bias,
                        device=device)

    def forward(self, x):
        return x.with_features(self.fc(x.features))
