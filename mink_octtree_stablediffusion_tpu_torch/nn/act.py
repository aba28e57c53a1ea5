"""Activations on sparse tensors.

Port of `mink_octtree_stablediffusion_tpu/nn/act.py`: the named table
``_ACTS`` (``get_act``) with JAX's semantics (``gelu`` is the tanh
approximation, as ``jax.nn.gelu``'s default; ``softplus`` is
``logaddexp(x, 0)``), ``hardshrink``, ``softshrink``, ``threshold``,
``apply_fn`` and the named wrappers, which act on ``.features`` and keep
the padding invariant, and the modules ``Dropout``, ``Sinusoidal``,
``PReLU``, ``RReLU``, ``AlphaDropout`` and ``AdaptiveLogSoftmaxWithLoss``.
The random modules are the identity (``RReLU``: its mean slope) unless
called with ``deterministic=False``, and then draw from the
``torch.Generator`` they are given.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .linear import Dense


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


_ACTS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "elu": F.elu,
    "silu": F.silu,
    "swish": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "celu": F.celu,
    "selu": F.selu,
    "leaky_relu": F.leaky_relu,
    "relu6": lambda x: x.clamp(0.0, 6.0),
    "sigmoid": torch.sigmoid,
    "hardsigmoid": F.hardsigmoid,
    "tanh": torch.tanh,
    "hardtanh": lambda x: x.clamp(-1.0, 1.0),
    "softplus": _softplus,
    "softsign": lambda x: x / (x.abs() + 1.0),
    "mish": lambda x: x * torch.tanh(_softplus(x)),
    "hardswish": F.hardswish,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "softmin": lambda x: torch.softmax(-x, dim=-1),
    "log_sigmoid": F.logsigmoid,
    # shrink family (torch defaults: lambd=0.5)
    "hardshrink": lambda x: hardshrink(x),
    "softshrink": lambda x: softshrink(x),
    "tanhshrink": lambda x: x - torch.tanh(x),
}


def hardshrink(x: torch.Tensor, lambd: float = 0.5) -> torch.Tensor:
    """``torch.nn.Hardshrink``: x where |x| > lambd, else 0."""
    return torch.where(x.abs() > lambd, x, torch.zeros_like(x))


def softshrink(x: torch.Tensor, lambd: float = 0.5) -> torch.Tensor:
    """``torch.nn.Softshrink``: sign(x)·max(|x| − lambd, 0)."""
    return torch.sign(x) * (x.abs() - lambd).clamp(min=0.0)


def threshold(x: torch.Tensor, thresh: float, value: float) -> torch.Tensor:
    """``torch.nn.Threshold``: x where x > thresh, else ``value``."""
    return torch.where(x > thresh, x, torch.full_like(x, value))


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Named activation lookup."""
    return _ACTS[name]


def apply_fn(x, fn: Callable):
    """An elementwise function of the features of a SparseTensor or a
    TensorField."""
    return x.with_features(fn(x.features))


def relu(x):
    return apply_fn(x, F.relu)


def elu(x):
    return apply_fn(x, F.elu)


def silu(x):
    return apply_fn(x, F.silu)


def gelu(x):
    return apply_fn(x, _ACTS["gelu"])


def sigmoid(x):
    return apply_fn(x, torch.sigmoid)


def tanh(x):
    return apply_fn(x, torch.tanh)


def softmax(x):
    return apply_fn(x, _ACTS["softmax"])


def _uniform(f: torch.Tensor, generator: Optional[torch.Generator]):
    return torch.rand(f.shape, generator=generator, dtype=f.dtype,
                      device=f.device)


class Dropout(nn.Module):
    """Feature dropout: with ``deterministic=False`` each feature is kept
    with probability 1 − rate and scaled by 1 / (1 − rate)."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        if deterministic or self.rate == 0.0:
            return x
        f = x.features
        if self.rate == 1.0:
            return x.with_features(torch.zeros_like(f))
        keep = _uniform(f, generator) < 1.0 - self.rate
        return x.with_features(torch.where(keep, f / (1.0 - self.rate),
                                           torch.zeros_like(f)))


class Sinusoidal(nn.Module):
    """``cos(x W + b) @ coef`` feature map (the reference fork's
    ``MinkowskiSinusoidal``).  ``kernel`` [in, out] and ``coef`` [out, out]
    keep the flax layout, LeCun normal; ``bias`` zero."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_channels, out_channels,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))
        self.coef = nn.Parameter(torch.empty(out_channels, out_channels,
                                             device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            for w in (self.kernel, self.coef):
                w.normal_(0.0, 1.0 / math.sqrt(w.shape[0]),
                          generator=generator)
            self.bias.zero_()

    def forward(self, x):
        return x.with_features(
            torch.cos(x.features @ self.kernel + self.bias) @ self.coef)


class PReLU(nn.Module):
    """Learnable negative slope, one shared by default (``num_parameters``
    = C for one per channel), initialised to ``alpha_init``."""

    def __init__(self, num_parameters: int = 1, alpha_init: float = 0.25,
                 device=None):
        super().__init__()
        self.alpha_init = alpha_init
        self.alpha = nn.Parameter(torch.empty(num_parameters, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.alpha.fill_(self.alpha_init)

    def forward(self, x):
        f = x.features
        return x.with_features(torch.where(f >= 0, f, f * self.alpha))


class RReLU(nn.Module):
    """Randomized leaky ReLU: with ``deterministic=False`` a negative slope
    ~U[lower, upper) per element, else the mean slope."""

    def __init__(self, lower: float = 1.0 / 8.0, upper: float = 1.0 / 3.0):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        f = x.features
        if deterministic:
            slope = (self.lower + self.upper) / 2.0
        else:
            slope = self.lower + (self.upper - self.lower) * _uniform(
                f, generator)
        return x.with_features(torch.where(f >= 0, f, f * slope))


class AlphaDropout(nn.Module):
    """SELU-compatible dropout (``torch.nn.AlphaDropout``): with
    ``deterministic=False`` dropped features take SELU's saturation value
    and the output is rescaled to keep mean and variance."""

    ALPHA_P = -1.7580993408473766  # -scale · alpha of SELU

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        if deterministic or self.rate == 0.0:
            return x
        f, p = x.features, self.rate
        q = 1.0 - p
        a = (q + self.ALPHA_P ** 2 * q * p) ** -0.5
        b = -a * self.ALPHA_P * p
        keep = _uniform(f, generator) < q
        return x.with_features(
            a * torch.where(keep, f, torch.full_like(f, self.ALPHA_P)) + b)


class AdaptiveLogSoftmaxWithLoss(nn.Module):
    """Hierarchical softmax over frequency bands
    (``torch.nn.AdaptiveLogSoftmaxWithLoss``): the head scores the
    classes below the first cutoff plus one bucket per tail cluster; each
    tail cluster is scored through a low-rank projection.  Every band's
    log-probabilities are computed for all rows and the target's band is
    selected, as in the JAX package.  Returns ``(log-probability of each
    row's target, mean negative log-likelihood)``."""

    def __init__(self, in_features: int, n_classes: int, cutoffs=(),
                 div_value: float = 4.0, device=None):
        super().__init__()
        self.cutoffs = tuple(cutoffs) + (n_classes,)
        n_clusters = len(self.cutoffs) - 1
        self.head = Dense(in_features, self.cutoffs[0] + n_clusters,
                          bias=False, device=device)
        for i in range(n_clusters):
            dim = max(int(in_features / (div_value ** (i + 1))), 1)
            lo, hi = self.cutoffs[i], self.cutoffs[i + 1]
            self.add_module(f"tail{i}_proj", Dense(in_features, dim,
                                                   bias=False, device=device))
            self.add_module(f"tail{i}_out", Dense(dim, hi - lo, bias=False,
                                                  device=device))

    def forward(self, x, target: torch.Tensor):
        f = x.features if hasattr(x, "features") else x
        c0 = self.cutoffs[0]
        head_lp = torch.log_softmax(self.head(f), dim=-1)
        t = target.long()
        lp = head_lp.gather(-1, t.clamp(0, c0 - 1)[:, None])[:, 0]
        for i in range(len(self.cutoffs) - 1):
            lo, hi = self.cutoffs[i], self.cutoffs[i + 1]
            h = getattr(self, f"tail{i}_proj")(f)
            tail_lp = torch.log_softmax(getattr(self, f"tail{i}_out")(h),
                                        dim=-1)
            t_lp = tail_lp.gather(-1, (t.clamp(lo, hi - 1) - lo)[:, None])
            in_band = (t >= lo) & (t < hi)
            lp = torch.where(in_band, head_lp[:, c0 + i] + t_lp[:, 0], lp)
        return lp, -lp.mean()
