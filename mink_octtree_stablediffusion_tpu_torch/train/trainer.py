"""Training harness: train state, the single-device and data-parallel
steps, checkpoints.

Port of `TrainState` (with `create_mixed_precision`), `make_train_step`,
`make_dp_train_step`, `split_device_rngs` and `CheckpointManager` from
`mink_octtree_stablediffusion_tpu/train/trainer.py`, with ``torch.save``/
``torch.load`` in place of orbax.  PyTorch keeps the parameters, the
BatchNorm running statistics and the optimizer state inside the module and
the optimizer, so the state is those two objects and the step count, and a
step updates them in place.

Data parallelism runs one process per rank over ``torch.distributed``
(`parallel/`): every rank holds the whole model, starts from rank 0's
parameters and buffers (``broadcast_module``), runs its own batch, and
the step takes the float32 mean of the ranks' gradients before the
optimizer, so the ranks stay equal bit for bit.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils import profiling
from .optim import MixedPrecisionParams, cast_params

_CKPT = re.compile(r"step_(\d+)\.pt")
# The size of one all-reduce's flat float32 bucket (DDP's default).
_BUCKET_BYTES = 25 << 20


@dataclass
class TrainState:
    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create_mixed_precision(cls, module: torch.nn.Module,
                               make_optimizer: Callable,
                               dtype: torch.dtype = torch.bfloat16
                               ) -> "TrainState":
        """bf16 parameter storage without losing the float32 start: the
        optimizer (``make_optimizer(params)`` inside
        ``MixedPrecisionParams``) takes its float32 master from the
        parameters as they are, and only then are the module's parameters
        rounded to ``dtype``."""
        opt = MixedPrecisionParams(module.parameters(), make_optimizer)
        cast_params(module, dtype)
        return cls(module, opt)


def make_train_step(loss_fn: Callable):
    """``step(state, batch, *args, **kw) -> (loss, aux)`` for
    ``loss_fn(module, batch, *args, **kw) -> (loss, aux)``: zero the
    gradients, run the forward in train mode (BatchNorm layers move their
    running statistics in place) and the loss, backward, one optimizer
    step.  The module is whatever the optimizer updates: the VAE, or for
    diffusion a ``ModuleDict`` of the UNet and the coordinate NLL (a
    frozen VAE stays outside it, in the loss); gradient clipping is the
    optimizer's (``DiffusionOptimizer``).  The returned loss and aux are
    detached; nothing waits for the device.  Profiling spans (``utils.
    profiling``): ``train.step`` around the step, with ``train.forward``,
    ``train.backward`` and ``train.optimizer`` inside it."""

    def step(state: TrainState, batch, *args, **kw):
        with profiling.span("train.step"):
            loss, aux = _forward_backward(loss_fn, state, batch, *args, **kw)
            with profiling.span("train.optimizer"):
                state.optimizer.step()
            state.step += 1
            return loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step


def _forward_backward(loss_fn: Callable, state: TrainState, batch,
                      *args, **kw):
    """Zero the gradients, run ``loss_fn`` in train mode (span
    ``train.forward``), backward (``train.backward``)."""
    state.module.train()
    state.optimizer.zero_grad(set_to_none=True)
    with profiling.span("train.forward"):
        loss, aux = loss_fn(state.module, batch, *args, **kw)
    with profiling.span("train.backward"):
        loss.backward()
    return loss, aux


def _trained_params(optimizer) -> List[torch.nn.Parameter]:
    """The live parameters ``optimizer`` updates, in its order."""
    if isinstance(optimizer, MixedPrecisionParams):
        return optimizer.params
    return [p for g in optimizer.param_groups for p in g["params"]]


def _group_src(group) -> int:
    """The global rank of the group's first rank."""
    group = group if group is not None else dist.group.WORLD
    return dist.get_global_rank(group, 0)


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, group=None) -> None:
    """Copy the group's first rank's parameters and buffers into every
    rank's ``module`` (JAX's replicated parameters).  Call it before
    ``TrainState.create_mixed_precision``, whose master is taken from the
    parameters."""
    src = _group_src(group)
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor],
                    group=None) -> List[torch.Tensor]:
    """The float32 mean over the group of each tensor (same shapes on every
    rank): the tensors are packed as float32 into flat buckets of about
    ``_BUCKET_BYTES``, each bucket summed with one ``all_reduce`` (gloo has
    no average) and divided by the group's size.  A float32 tensor is
    overwritten with its mean and returned (no second copy of the
    gradients); any other gets a new float32 tensor.  Every rank gets the
    same bits."""
    world = dist.get_world_size(group)
    out: List[Optional[torch.Tensor]] = [
        t if t.dtype == torch.float32 else None for t in tensors]
    i = 0
    while i < len(tensors):
        j, size = i, 0
        while j < len(tensors) and (j == i or size + 4 * tensors[j].numel()
                                    <= _BUCKET_BYTES):
            size += 4 * tensors[j].numel()
            j += 1
        part = tensors[i:j]
        bucket = torch.cat([t.reshape(-1).float() for t in part])
        dist.all_reduce(bucket, group=group)
        bucket.div_(world)
        for k, m in zip(range(i, j), bucket.split([t.numel() for t in part])):
            if out[k] is None:
                out[k] = m.view(tensors[k].shape)
            else:
                out[k].copy_(m.view(tensors[k].shape))
        i = j
    return out


def make_dp_train_step(loss_fn: Callable, group=None):
    """The data-parallel step over the process ``group`` (default: all
    ranks): ``step(state, batch, *args, **kw) -> (loss, aux)`` for the
    ``loss_fn`` of ``make_train_step``, called on every rank with the
    rank's own batch.

    After the backward pass each trained parameter's gradient is cast to
    float32 and averaged over the ranks (``all_reduce_mean``; a parameter
    that got no gradient on a rank counts as zero there, and gets none if
    no rank gave it one), then the optimizer steps: under
    ``TrainState.create_mixed_precision`` the float32 mean goes to the
    master unrounded, as JAX upcasts before its ``pmean`` so that the
    master update is exact.  The loss, the aux metrics and every floating
    buffer (BatchNorm's running statistics) are averaged too.  A SyncBN
    model (``process_group``) syncs its batch statistics inside the
    forward.  The module is not wrapped in DDP: the loss functions call
    module methods and ``ModuleDict`` members directly, past DDP's
    forward.  ``step.comm`` holds the last step's collective payload
    (``bytes`` a rank sends into its all-reduces) and the host seconds
    spent in them, counted from a point where the device has finished the
    backward, so they hold no tail of it.  It carries the profiling spans
    of ``make_train_step``'s step."""

    def step(state: TrainState, batch, *args, **kw):
        with profiling.span("train.step"):
            module, opt = state.module, state.optimizer
            loss, aux = _forward_backward(loss_fn, state, batch, *args, **kw)
            params = _trained_params(opt)
            dev = params[0].device
            has = torch.tensor([float(p.grad is not None) for p in params],
                               device=dev)
            grads = [p.grad if p.grad is not None else
                     torch.zeros(p.shape, device=dev) for p in params]
            keys = sorted(aux)
            metrics = torch.stack([loss.detach().float()] +
                                  [aux[k].detach().float() for k in keys])
            buffers = [b for b in module.buffers() if b.is_floating_point()]
            sent = grads + [has, metrics] + buffers
            if dev.type == "cuda":
                # The all-reduce waits for the stream anyway; without this
                # its seconds would hold the backward's queued kernels.
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            mean = all_reduce_mean(sent, group)
            step.comm = {"seconds": time.perf_counter() - t0,
                         "bytes": 4 * sum(t.numel() for t in sent)}
            n = len(params)
            grads, has, metrics = mean[:n], mean[n], mean[n + 1]
            grads = [g if h > 0 else None
                     for g, h in zip(grads, has.tolist())]
            with torch.no_grad():
                for b, m in zip(buffers, mean[n + 2:]):
                    if m is not b:  # float32 buffers were averaged in place
                        b.copy_(m)
            with profiling.span("train.optimizer"):
                if isinstance(opt, MixedPrecisionParams):
                    opt.step(grads=grads)
                else:
                    for p, g in zip(params, grads):
                        p.grad = None if g is None else g.to(p.dtype)
                    opt.step()
            state.step += 1
            return metrics[0], dict(zip(keys, metrics[1:]))

    step.comm = {"seconds": 0.0, "bytes": 0}
    return step


def split_device_rngs(seed: int, num_devices: int,
                      device=None) -> List[torch.Generator]:
    """One seeded ``torch.Generator`` per rank (JAX splits one key into
    ``num_devices``): the seeds are ``numpy.random.SeedSequence(seed)``'s
    children, so no two ranks, nor two seeds, share a stream."""
    children = np.random.SeedSequence(seed).spawn(num_devices)
    return [torch.Generator(device=device).manual_seed(
        int(c.generate_state(1, np.uint64)[0] >> np.uint64(1)))
        for c in children]


class CheckpointManager:
    """One file per saved step, ``<directory>/step_<step>.pt``, holding the
    module's ``state_dict`` (parameters and running statistics), the
    optimizer's and the step; ``restore`` resumes all three."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step):08d}.pt")

    def save(self, step: int, state: TrainState) -> None:
        payload = {"model": state.module.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "step": int(state.step)}
        tmp = self.path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))  # a reader never sees half a file

    def latest_step(self) -> Optional[int]:
        steps = [int(m.group(1)) for m in map(_CKPT.fullmatch,
                                              os.listdir(self.directory))
                 if m]
        return max(steps) if steps else None

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Auto-resume: load the given (default: latest) step into
        ``state``; without a checkpoint, return ``state`` unchanged."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state
        dev = next(state.module.parameters()).device
        payload = torch.load(self.path(step), map_location=dev,
                             weights_only=True)
        state.module.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state
