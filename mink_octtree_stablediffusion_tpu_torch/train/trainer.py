"""Training harness: train state, the single-device step, checkpoints.

Port of `TrainState`, `make_train_step` and `CheckpointManager` from
`mink_octtree_stablediffusion_tpu/train/trainer.py`, with ``torch.save``/
``torch.load`` in place of orbax.  PyTorch keeps the parameters, the
BatchNorm running statistics and the optimizer state inside the module and
the optimizer, so the state is those two objects and the step count, and a
step updates them in place.  The data-parallel step is not ported yet.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Callable, Optional

import torch

_CKPT = re.compile(r"step_(\d+)\.pt")


@dataclass
class TrainState:
    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_train_step(loss_fn: Callable):
    """``step(state, batch, *args, **kw) -> (loss, aux)`` for
    ``loss_fn(module, batch, *args, **kw) -> (loss, aux)``: zero the
    gradients, run the forward in train mode (BatchNorm layers move their
    running statistics in place) and the loss, backward, one optimizer
    step.  The module is whatever the optimizer updates: the VAE, or for
    diffusion a ``ModuleDict`` of the UNet and the coordinate NLL (a
    frozen VAE stays outside it, in the loss); gradient clipping is the
    optimizer's (``DiffusionOptimizer``).  The returned loss and aux are detached; nothing waits for the
    device."""

    def step(state: TrainState, batch, *args, **kw):
        state.module.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(state.module, batch, *args, **kw)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step


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
