"""Optimizers and learning-rate schedules.

Port of `vae_optimizer`, `warmup_cosine` and `diffusion_optimizer` from
`mink_octtree_stablediffusion_tpu/train/optim.py`: Adam for the VAE
(`examples/ae_res.py:908-913` of the reference); for diffusion, global-norm
clipping at 0.5, then AdamW with a linear-warmup → cosine schedule
(`examples/diffusion.py:661-694,834`).  Adafactor is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import numpy as np
import torch


def vae_optimizer(params: Iterable[torch.nn.Parameter],
                  lr: float = 1e-3) -> torch.optim.Adam:
    """Adam with optax's defaults: β (0.9, 0.999) and eps 1e-8 added to
    ``sqrt(v̂)``.  ``torch.optim.Adam`` takes the same step,
    ``lr·m̂ / (sqrt(v̂) + eps)`` with bias-corrected moments, as
    ``optax.adam``."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_scale: float = 0.0) -> Callable[[int], float]:
    """Linear warmup from 0 → cosine annealing to ``final_scale·base_lr``,
    as a function of the update count from 0: optax's ``join_schedules``
    of ``linear_schedule`` and ``cosine_decay_schedule``, with their
    formulas evaluated in float32 as optax does."""
    f = np.float32
    warm = max(warmup_steps, 1)
    decay = max(total_steps - warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f(1) - f(min(max(count, 0), warm)) / f(warm)
            return float(f(0.0 - base_lr) * frac + f(base_lr))
        c = f(min(count - warmup_steps, decay))
        cosine = f(0.5) * (f(1) + np.cos(f(np.pi) * c / f(decay)))
        return float(f(base_lr) * (f(1.0 - final_scale) * cosine +
                                   f(final_scale)))

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: where the global L2 norm of
    ``grads`` is ≥ ``max_norm``, each becomes ``(g / norm) · max_norm``;
    below it they stay exactly as they are (``clip_grad_norm_`` would add
    1e-6 to the norm and scale always).  Returns the norm; nothing waits
    for the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm


class DiffusionOptimizer(torch.optim.AdamW):
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(schedule,
    weight_decay))``: each ``step`` clips the gradients, sets the learning
    rate to ``schedule(update_count)`` with the count from 0 (so the first
    update of a warmup has lr 0 and moves nothing) and takes AdamW's step
    (β (0.9, 0.999), eps 1e-8 added to ``sqrt(v̂)``, decoupled weight decay
    on every parameter: ``p ← p − lr·(m̂/(sqrt(v̂)+eps) + wd·p)``, as optax).
    The count lives in the parameter group, so the optimizer's
    ``state_dict`` carries the schedule's position."""

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float = 1e-2, clip_norm: float = 0.5):
        super().__init__(params, lr=schedule(0), betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=weight_decay)
        self.schedule = schedule
        self.clip_norm = clip_norm
        for group in self.param_groups:
            group["update_count"] = 0

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups
                 for p in group["params"] if p.grad is not None]
        if grads:
            clip_by_global_norm_(grads, self.clip_norm)
        for group in self.param_groups:
            group["lr"] = self.schedule(group["update_count"])
            group["update_count"] += 1
        return super().step(closure)


def diffusion_optimizer(params: Iterable[torch.nn.Parameter],
                        base_lr: float = 1e-4, warmup_steps: int = 1000,
                        total_steps: int = 100_000,
                        weight_decay: float = 1e-2,
                        clip_norm: float = 0.5) -> DiffusionOptimizer:
    """AdamW + warmup-cosine + global-norm clipping at 0.5."""
    return DiffusionOptimizer(
        params, warmup_cosine(base_lr, warmup_steps, total_steps),
        weight_decay=weight_decay, clip_norm=clip_norm)
