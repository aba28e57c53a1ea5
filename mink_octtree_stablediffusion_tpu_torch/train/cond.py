"""Class-conditioned diffusion on the latent canvas: the counterpart of the
conditional-diffusion phase of `scripts/cond_control.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.cond \\
        --ckpt_dir ckpt_generalize --cond_into_time --steps_diff 10000
    python -m mink_octtree_stablediffusion_tpu_torch.train.cond \\
        --device cpu --resolution 32 --points 512 --input_capacity 1024 \\
        --train_shapes 8 --batch_size 2 --vae_channel 4 8 8 8 4 \\
        --unet_channel 4 8 8 8 --group 4 --cross_attention_dim 16 \\
        --steps_diff 2 --ckpt_dir ckpt_generalize_tiny

Same flags and defaults as the script's diffusion phase (resolution 64,
batch 4, 512 train `ProceduralShapes` with ``composite_prob`` 0.25, VAE
(32, 128, 512, 512, 4), UNet (4, 128, 256, 384) with group 32, a
[4 classes, ``cond_tokens`` 4, ``cross_attention_dim`` 256] class table
from ``RandomState(7)``, learned (``--embed learned``, the default: the
table is the model's ``cond_table`` parameter) or frozen, 10% condition
dropout, AdamW at ``lr_diff`` 2e-4 on a 100-step warmup, the ``sample``
target, seed 0; full attention over one canvas), plus ``--device``
(default: the card).  The VAE comes from the
latest ``train.generalize`` checkpoint under ``<ckpt_dir>/vae``, or, where
there is none, from random weights of ``--seed``.  Each step encodes the
batch onto the canvas (frozen VAE), conditions every instance on its
class's table rows, zeroes each instance's condition with probability
``--cond_dropout`` (classifier-free guidance), and takes the diffusion
loss through the UNet's cross-attention (and ``--cond_into_time``).
Checkpoints go to ``<ckpt_dir>/diff_cond`` every 2000 steps and at the
end; a run resumes there (``--skip_diff`` restores without training).

Not ported: the script's classifier (the oracle, `models/classification.py`)
and its sampling and scoring of each class (ROADMAP.md queue A item 6).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

from ..data import ProceduralShapes
from ..diffusion import DDPMScheduler
from ..utils.device import make_generator, resolve_device
from .diffusion import load_vae_checkpoint
from .generalize import (build_diffusion_loss_fn, canvas_unet, canvas_vae,
                         collate, run_steps, shape_stream)
from .optim import diffusion_optimizer
from .trainer import CheckpointManager, TrainState, make_train_step

log = logging.getLogger("train_generalize")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--points", type=int, default=32768)
    p.add_argument("--input_capacity", type=int, default=65536)
    p.add_argument("--train_shapes", type=int, default=512)
    p.add_argument("--composite_prob", type=float, default=0.25)
    p.add_argument("--vae_channel", type=int, nargs=5,
                   default=[32, 128, 512, 512, 4])
    p.add_argument("--unet_channel", type=int, nargs=4,
                   default=[4, 128, 256, 384])
    p.add_argument("--cross_attention_dim", type=int, default=256)
    p.add_argument("--cond_tokens", type=int, default=4)
    p.add_argument("--cond_dropout", type=float, default=0.1)
    p.add_argument("--embed", choices=["frozen", "learned"],
                   default="learned")
    p.add_argument("--time_norm", choices=["default", "scale_shift"],
                   default="default")
    p.add_argument("--cond_into_time", action="store_true")
    p.add_argument("--stream", action="store_true")
    p.add_argument("--steps_diff", type=int, default=10000)
    p.add_argument("--vae_scale", type=float, default=0.1428)
    p.add_argument("--canvas_noise", type=float, default=1.0)
    p.add_argument("--lr_diff", type=float, default=2e-4)
    p.add_argument("--group", type=int, default=32)
    p.add_argument("--prediction_type",
                   choices=["epsilon", "sample", "v_prediction"],
                   default="sample")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt_dir", type=str, default="ckpt_generalize")
    p.add_argument("--skip_diff", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def class_table(n_classes: int, tokens: int, dim: int) -> np.ndarray:
    """The script's table: float32 [n_classes, tokens, dim] from
    ``RandomState(7)``."""
    return np.random.RandomState(7).randn(n_classes, tokens,
                                          dim).astype(np.float32)


def main(argv=None) -> dict:
    cfg = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    res, b, cap = cfg.resolution, cfg.batch_size, cfg.input_capacity
    dev = resolve_device(cfg.device)
    train_ds = ProceduralShapes(resolution=res, num_samples=cfg.train_shapes,
                                points_per_shape=cfg.points, seed=cfg.seed,
                                split="train",
                                composite_prob=cfg.composite_prob)
    n_classes = len(train_ds.CLASSES)
    np_rng = np.random.RandomState(cfg.seed + 1)
    if cfg.stream:
        next_batch = shape_stream(train_ds, b, cap, 3)
    else:
        pool = [train_ds[i] for i in range(cfg.train_shapes)]

        def next_batch():
            return collate([pool[i] for i in
                            np_rng.randint(0, cfg.train_shapes, b)], cap)
    sizes = dict(input_capacity=cap, batch_size=b, resolution=res)
    vae = canvas_vae(vae_channel=cfg.vae_channel,
                     canvas_noise=cfg.canvas_noise, device=dev,
                     seed=cfg.seed, **sizes)
    vae_dir = os.path.join(cfg.ckpt_dir, "vae")
    if (os.path.isdir(vae_dir) and
            CheckpointManager(vae_dir).latest_step() is not None):
        log.info("restored VAE at step %d",
                 load_vae_checkpoint(vae, vae_dir, dev))
    else:
        log.info("no VAE checkpoint under %s: random weights of seed %d",
                 vae_dir, cfg.seed)
    vae.requires_grad_(False)

    table = torch.as_tensor(class_table(n_classes, cfg.cond_tokens,
                                        cfg.cross_attention_dim), device=dev)
    unet = canvas_unet(unet_channel=cfg.unet_channel, batch_size=b,
                       resolution=res, group=cfg.group, with_cross_attn=True,
                       cross_attention_dim=cfg.cross_attention_dim,
                       time_embedding_norm=cfg.time_norm,
                       cond_into_time=cfg.cond_into_time, device=dev,
                       seed=cfg.seed + 1)
    log.info("unet params: %d", sum(p.numel() for p in unet.parameters()))
    model = torch.nn.ModuleDict({"unet": unet})
    if cfg.embed == "learned":
        model.register_parameter("cond_table",
                                 torch.nn.Parameter(table.clone()))
    state = TrainState(model, diffusion_optimizer(
        model.parameters(), cfg.lr_diff, warmup_steps=100,
        total_steps=cfg.steps_diff))
    ckpt = CheckpointManager(os.path.join(cfg.ckpt_dir, "diff_cond"))
    state = ckpt.restore(state)
    result = {"resolution": res, "embed": cfg.embed}
    if cfg.skip_diff:
        log.info("restored cond diffusion at step %d", state.step)
    else:
        log.info("cond diffusion from step %d", state.step)
        sched = DDPMScheduler.create(prediction_type=cfg.prediction_type)
        step_fn = make_train_step(build_diffusion_loss_fn(
            vae, sched, vae_scale=cfg.vae_scale,
            prediction_type=cfg.prediction_type, device=dev,
            cond_table=table, cond_dropout=cfg.cond_dropout, **sizes))
        result["diff_loss_last"] = run_steps(
            "cond diff", state, step_fn, next_batch,
            make_generator(cfg.seed, dev), cfg.steps_diff, ckpt, 200)
    result["steps_diff"] = state.step
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
