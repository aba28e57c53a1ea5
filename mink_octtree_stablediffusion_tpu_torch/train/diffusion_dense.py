"""Dense-voxel diffusion: the counterpart of `examples/diffusion_dense.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.diffusion_dense \\
        --steps 100 [--with_cond]
    python -m mink_octtree_stablediffusion_tpu_torch.train.diffusion_dense \\
        --device cpu --resolution 8 --block_channels 8 16 --steps 2

Same flags and defaults as the JAX example (resolution 32, batch 2, block
channels (32, 64, 128), lr 1e-4, seed 42; ``--with_cond`` with
``--cross_attention_dim`` 64), plus ``--device`` (default: the card).
Occupancy grids ``[B, R, R, R, 1]`` of 128 `SyntheticShapes` are diffused
by `UNet3DModel` (attention at the deepest level), or with ``--with_cond``
by `UNet3DConditionModel` (self + cross attention at the deepest level,
head dim ``max(min(block_channels) // 2, 8)``, 8 groups) conditioned on a
fixed per-class token table ``[n_classes, 1, cross_attention_dim]`` drawn
from ``RandomState(0)`` (the stand-in for CLIP embeddings).  A step draws
per-instance DDPM timesteps and noise, ``add_noise``, and takes the MSE
of the predicted noise; the optimizer is ``diffusion_optimizer`` (clip
0.5, AdamW, a 1,000-step warmup).  Without ``--steps`` it runs on, as
the example does.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

from ..data import SyntheticShapes, batch_iterator
from ..diffusion import DDPMScheduler
from ..models import UNet3DConditionModel, UNet3DModel
from ..utils.device import make_generator, resolve_device
from .optim import diffusion_optimizer
from .trainer import TrainState, make_train_step

log = logging.getLogger("diffusion_dense")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--block_channels", type=int, nargs="+",
                   default=[32, 64, 128])
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--with_cond", action="store_true")
    p.add_argument("--cross_attention_dim", type=int, default=64)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def build_model(*, block_channels, with_cond: bool, cross_attention_dim: int,
                device, seed: int = 0) -> torch.nn.Module:
    bc = tuple(block_channels)
    if with_cond:
        return UNet3DConditionModel(
            out_channels=1, in_channels=1, block_channels=bc,
            cross_attention_dim=cross_attention_dim,
            attention_head_dim=max(min(bc) // 2, 8), groups=8,
            cross_attn_levels=(len(bc) - 1,), device=device, seed=seed)
    return UNet3DModel(out_channels=1, in_channels=1, block_channels=bc,
                       attn_levels=(len(bc) - 1,), device=device, seed=seed)


def densify(samples, resolution: int) -> np.ndarray:
    """Occupancy grids [B, R, R, R, 1] of the samples' voxels."""
    r = resolution
    grid = np.zeros((len(samples), r, r, r, 1), np.float32)
    for i, s in enumerate(samples):
        v = s["coords"]
        grid[i, v[:, 0], v[:, 1], v[:, 2], 0] = 1.0
    return grid


def class_table(n_classes: int, dim: int) -> np.ndarray:
    """The example's fixed token table [n_classes, 1, dim] from
    ``RandomState(0)``."""
    return np.random.RandomState(0).randn(n_classes, 1, dim).astype(
        np.float32)


def build_loss_fn(sched: DDPMScheduler, *, with_cond: bool, device):
    """``loss_fn(model, batch, generator=None, timesteps=None, noise=None)
    -> (loss, {})`` for ``batch = (x0 [B, R, R, R, 1], cond [B, 1, D] or
    None)``; the timesteps and the noise are drawn from ``generator``
    unless given."""

    def loss_fn(model, batch, generator=None, timesteps=None, noise=None):
        x0, cond = (None if a is None else
                    torch.as_tensor(np.asarray(a), device=device)
                    for a in batch)
        if timesteps is None:
            timesteps = torch.randint(0, sched.num_train_timesteps,
                                      (x0.shape[0],), generator=generator,
                                      device=device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=device)
        xt = sched.add_noise(x0, noise, timesteps)
        eps = model(xt, timesteps, cond) if with_cond else \
            model(xt, timesteps)
        return ((eps - noise) ** 2).mean(), {}

    return loss_fn


def main(argv=None) -> dict:
    cfg = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(cfg.device)
    np_rng = np.random.RandomState(cfg.seed)
    ds = SyntheticShapes(resolution=cfg.resolution, num_samples=128,
                         with_class=cfg.with_cond)
    net = build_model(block_channels=cfg.block_channels,
                      with_cond=cfg.with_cond,
                      cross_attention_dim=cfg.cross_attention_dim,
                      device=dev, seed=cfg.seed)
    log.info("params: %d", sum(p.numel() for p in net.parameters()))
    table = class_table(len(ds.CLASSES), cfg.cross_attention_dim)
    state = TrainState(net, diffusion_optimizer(net.parameters(), cfg.lr))
    step_fn = make_train_step(build_loss_fn(
        DDPMScheduler.create(), with_cond=cfg.with_cond, device=dev))
    gen = make_generator(cfg.seed, dev)
    t0 = time.time()
    while True:
        for samples in batch_iterator(ds, cfg.batch_size, np_rng):
            cond = (table[[s["label"] for s in samples]] if cfg.with_cond
                    else None)
            loss, _ = step_fn(state, (densify(samples, cfg.resolution),
                                      cond), gen)
            step = state.step
            if step % 5 == 0 or (cfg.steps and step >= cfg.steps):
                log.info("step %d loss %.5f (%.2f s/step)", step,
                         float(loss), (time.time() - t0) / 5)
                t0 = time.time()
            if cfg.steps and step >= cfg.steps:
                out = {"final_loss": float(loss), "step": step}
                print(json.dumps(out), flush=True)
                return out


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
