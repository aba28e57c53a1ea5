"""Optimizers, learning-rate schedules and bf16 parameter storage.

Port of `vae_optimizer`, `warmup_cosine`, `diffusion_optimizer`,
`adafactor_diffusion_optimizer`, `cast_params` and `mixed_precision_params`
from `mink_octtree_stablediffusion_tpu/train/optim.py`: Adam for the VAE
(`examples/ae_res.py:908-913` of the reference); for diffusion, global-norm
clipping at 0.5, then AdamW with a linear-warmup → cosine schedule
(`examples/diffusion.py:661-694,834`), or optax's Adafactor on the same
schedule; the canvas VAE of `scripts/e2e_generalize.py` takes clipping at
1.0 and Adam on a 20-step warmup (``canvas_vae_optimizer``).  With
``MixedPrecisionParams`` the module holds bf16 parameters and the
optimizer a float32 master copy.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..parallel.tp import sum_over_model


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
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         shards: Optional[Sequence] = None) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: where the global L2 norm of
    ``grads`` is ≥ ``max_norm``, each becomes ``(g / norm) · max_norm``;
    below it they stay exactly as they are (``clip_grad_norm_`` would add
    1e-6 to the norm and scale always).  Returns the norm; nothing waits
    for the device.  Under tensor parallelism ``shards[i]`` is the
    ``parallel.tp.ModelShard`` of a gradient that is this rank's slice of
    a parameter (None for a whole one): the slices' squares are summed
    over the model group, so that every rank clips by the norm of the
    whole gradients, as JAX's global arrays do."""
    norms = torch.stack(torch._foreach_norm(grads))
    sharded = [s for s in (shards or ()) if s is not None]
    if sharded:
        on = torch.tensor([s is not None for s in shards],
                          device=norms.device)
        sq = norms.square()
        part = sum_over_model(sq[on].sum(), sharded[0])
        norm = (sq[~on].sum() + part).sqrt()
    else:
        norm = torch.linalg.vector_norm(norms)
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm


def _clip_grads_(param_groups, max_norm: float) -> None:
    """``clip_by_global_norm_`` of the groups' gradients, each sharded
    one's ``ModelShard`` passed along."""
    params = [p for group in param_groups for p in group["params"]
              if p.grad is not None]
    if params:
        clip_by_global_norm_([p.grad for p in params], max_norm,
                             [getattr(p, "model_shard", None)
                              for p in params])


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
        _clip_grads_(self.param_groups, self.clip_norm)
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


def canvas_vae_optimizer(params: Iterable[torch.nn.Parameter],
                         base_lr: float = 1e-3,
                         total_steps: int = 6000) -> DiffusionOptimizer:
    """`scripts/e2e_generalize.py`'s VAE optimizer: ``optax.chain(
    clip_by_global_norm(1.0), adam(warmup_cosine(base_lr, 20,
    total_steps)))`` (Adam is AdamW without weight decay)."""
    return DiffusionOptimizer(params, warmup_cosine(base_lr, 20, total_steps),
                              weight_decay=0.0, clip_norm=1.0)


# optax 0.2.6's adafactor defaults: factor a second moment only over two
# dimensions of at least 128; decay 1 − (t + 1)^−0.8; eps added to g²
MIN_DIM_TO_FACTOR, DECAY_RATE, ADAFACTOR_EPS = 128, 0.8, 1e-30


def factored_dims(shape: Sequence[int]) -> Optional[tuple]:
    """optax's rule: the two largest dimensions ``(d1, d0)`` (second
    largest, largest; ties as ``np.argsort``), or None below 2 dimensions
    or when the second largest is smaller than ``MIN_DIM_TO_FACTOR``
    (the second moment is then kept whole)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class AdafactorOptimizer(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(clip_norm), adafactor(schedule,
    multiply_by_parameter_scale=False, clipping_threshold=None,
    momentum=None))`` with optax 0.2.6's other defaults.  Each ``step``
    clips the gradients and, with ``t`` the update count from 0 and
    ``β_t = 1 − (t + 1)^−0.8``, keeps for a parameter factored over
    ``factored_dims`` (d1, d0) the row and column means of ``g² + eps``
    (over d0 and d1) as EMAs ``R``, ``C`` and steps ``p ← p −
    schedule(t)·g·(R/mean(R))^−½·C^−½``; any other parameter keeps the
    whole EMA ``V`` of ``g² + eps`` and steps ``p ← p −
    schedule(t)·g·V^−½``.  No momentum, no update clipping, no parameter
    scaling, no weight decay.  This is not ``torch.optim.Adafactor``,
    which factors the last two dimensions of every tensor and clips its
    update."""

    def __init__(self, params, schedule: Callable[[int], float],
                 clip_norm: float = 0.5):
        super().__init__(params, dict(lr=schedule(0)))
        self.schedule = schedule
        self.clip_norm = clip_norm
        for group in self.param_groups:
            group["update_count"] = 0

    @torch.no_grad()
    def step(self, closure=None):
        _clip_grads_(self.param_groups, self.clip_norm)
        f = np.float32
        for group in self.param_groups:
            t = group["update_count"]
            group["lr"] = lr = self.schedule(t)
            group["update_count"] += 1
            beta = float(f(1.0) - f(t + 1) ** f(-DECAY_RATE))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                g2 = g * g + ADAFACTOR_EPS
                st = self.state[p]
                shard = getattr(p, "model_shard", None)
                shape = list(p.shape)
                if shard is not None:  # factored as the whole parameter
                    shape[shard.dim] *= shard.size
                dims = factored_dims(tuple(shape))
                if dims is None:
                    if not st:
                        st["v"] = torch.zeros_like(p)
                    st["v"].mul_(beta).add_(g2, alpha=1.0 - beta)
                    u = g * st["v"].rsqrt()
                else:
                    d1, d0 = dims
                    sd = None if shard is None else shard.dim
                    mr, sr = _whole_mean(g2, d0, sd, shard)
                    mc, _ = _whole_mean(g2, d1, sd, shard)
                    if not st:
                        st["v_row"] = torch.zeros_like(mr)
                        st["v_col"] = torch.zeros_like(mc)
                    vr = st["v_row"].mul_(beta).add_(mr, alpha=1.0 - beta)
                    vc = st["v_col"].mul_(beta).add_(mc, alpha=1.0 - beta)
                    rd1 = d1 - 1 if d1 > d0 else d1
                    row = (vr / _whole_mean(vr, rd1, sr, shard, True)[0]
                           ).rsqrt()
                    u = g * row.unsqueeze(d0) * vc.rsqrt().unsqueeze(d1)
                p.add_(u * lr, alpha=-1.0)
        return None


def _whole_mean(x: torch.Tensor, d: int, sd: Optional[int], shard,
                keepdim: bool = False):
    """The mean of ``x`` over dimension ``d`` as the whole tensor has it,
    and the dimension of the result that is still sharded (or None):
    where ``x`` is a tensor-parallel slice sharded on ``sd`` and ``d`` is
    that dimension, the slices' sums are summed over the model group."""
    if sd is None or d != sd:
        kept = None if sd is None else sd - (0 if keepdim or sd < d else 1)
        return x.mean(d, keepdim=keepdim), kept
    total = sum_over_model(x.sum(d, keepdim=keepdim), shard)
    return total / (x.shape[d] * shard.size), None


def adafactor_diffusion_optimizer(params: Iterable[torch.nn.Parameter],
                                  base_lr: float = 1e-4,
                                  warmup_steps: int = 1000,
                                  total_steps: int = 100_000,
                                  clip_norm: float = 0.5
                                  ) -> AdafactorOptimizer:
    """Adafactor + warmup-cosine + global-norm clipping at 0.5: the
    memory-lean diffusion recipe (factored second moments in place of
    Adam's two moments per parameter)."""
    return AdafactorOptimizer(
        params, warmup_cosine(base_lr, warmup_steps, total_steps),
        clip_norm=clip_norm)


def cast_params(module: torch.nn.Module,
                dtype: torch.dtype = torch.bfloat16) -> torch.nn.Module:
    """Cast the floating-point parameters of ``module`` to ``dtype`` in
    place (buffers, such as BatchNorm's running statistics, stay as they
    are).  For training, prefer ``TrainState.create_mixed_precision``,
    which seeds the float32 master from the parameters before the cast."""
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module


class MixedPrecisionParams:
    """Half-precision parameter storage with a full-precision master copy
    (`mixed_precision_params`): the module's parameters stay in bf16, so
    no layer casts its weight on each call; the float32 master lives here
    and ``inner`` (built by ``make_inner`` over the master) steps it with
    the gradients upcast to float32, so updates below one bf16 ulp
    accumulate; after each step the live parameters are exactly
    ``round(master)``.  The master is taken from ``params`` as they are
    when this is made: make it before ``cast_params``.  Duck-types the
    ``torch.optim.Optimizer`` calls that ``make_train_step`` and
    ``CheckpointManager`` make."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 make_inner: Callable):
        self.params = list(params)
        self.master = [torch.nn.Parameter(p.detach().float().clone())
                       for p in self.params]
        for m, p in zip(self.master, self.params):
            if hasattr(p, "model_shard"):  # a tensor-parallel slice
                m.model_shard = p.model_shard
        self.inner = make_inner(self.master)

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, closure=None, grads=None):
        """One step of the master.  ``grads`` (one float32 tensor or None
        per parameter, in order) reach the master as they are, unrounded:
        the data-parallel step's float32 mean of the ranks' gradients;
        without them, each live gradient is upcast."""
        if grads is None:
            grads = [p.grad for p in self.params]
        for m, g in zip(self.master, grads):
            m.grad = None if g is None else g.to(m.dtype)
        self.inner.step()
        for p, m in zip(self.params, self.master):
            p.copy_(m)

    def state_dict(self) -> dict:
        return {"master": [m.detach() for m in self.master],
                "inner": self.inner.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for p, m, saved in zip(self.params, self.master, state["master"]):
            m.copy_(saved)
            p.copy_(m)
        self.inner.load_state_dict(state["inner"])
