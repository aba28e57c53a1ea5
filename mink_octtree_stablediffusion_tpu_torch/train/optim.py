"""Optimizers.

Port of `vae_optimizer` from `mink_octtree_stablediffusion_tpu/train/
optim.py` (the VAE's Adam, `examples/ae_res.py:908-913` of the reference).
The diffusion optimizers (AdamW with warmup-cosine and clipping) are not
ported yet.
"""

from __future__ import annotations

from typing import Iterable

import torch


def vae_optimizer(params: Iterable[torch.nn.Parameter],
                  lr: float = 1e-3) -> torch.optim.Adam:
    """Adam with optax's defaults: β (0.9, 0.999) and eps 1e-8 added to
    ``sqrt(v̂)``.  ``torch.optim.Adam`` takes the same step,
    ``lr·m̂ / (sqrt(v̂) + eps)`` with bias-corrected moments, as
    ``optax.adam``."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
