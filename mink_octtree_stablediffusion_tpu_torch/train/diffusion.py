"""Sparse latent-diffusion training: the counterpart of
`examples/train_diffusion.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.diffusion --steps 10
    python -m mink_octtree_stablediffusion_tpu_torch.train.diffusion \\
        --device cpu --input_capacity 4096 --vae_channel 8 16 32 32 4 \\
        --unet_channel 4 8 16 16 --group 4 --batch_size 2 --steps 3 \\
        --ckpt_dir ckpt_diffusion_tiny

Same flags and defaults as the JAX example (resolution 128, batch 4,
``input_capacity`` 65536, VAE (32, 128, 512, 512, 4) with the
`capacities()` schedule, UNet (4, 320, 640, 960) with group 32,
attention and the latent-derived ``attn_max_len`` and down capacities,
DDPM with 1000 ``scaled_linear`` steps, AdamW at lr 1e-4 with 1000 warmup
steps of a 100000-step cosine schedule, weight decay 1e-2, clipping 0.5,
the coordinate NLL at weight 0.01, synthetic shapes), plus ``--device``
(default: the card).  The VAE is frozen: random weights from ``--seed``,
or a checkpoint of ``train.vae`` (``--vae_ckpt``: its directory, latest
step); its encoder runs in eval mode without a graph and its mean,
scaled by ``--vae_scale``, is the clean latent.  Each step draws one
timestep per instance and the noise from a seeded generator, noises the
latent, runs the UNet, takes the ε-loss plus the NLL, backpropagates into
the UNet and the NLL's (μ, Σ), and steps the optimizer.  The run resumes
from the latest checkpoint in ``--ckpt_dir`` (the example always does),
logs every 10 steps and checkpoints every ``--save_every`` steps and at
the step cap; without a cap (``--steps 0``) it runs on, as the example.

Not ported yet (raise ``NotImplementedError``; ROADMAP.md queue A):
noise-point augmentation (``--noise_point_mode`` other than ``none``,
``--noise_near``), the sampling validation (``--val_every``), the UNet's
``--remat`` and the ModelNet40 dataset (``--data`` without
``--synthetic``).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..data import SyntheticShapes, batch_iterator, collate_pointclouds
from ..diffusion import CoordNLLParams, DDPMScheduler, diffusion_training_loss
from ..serve import generation_models
from ..tensor import sparse_tensor
from ..utils.device import make_generator, resolve_device
from .optim import diffusion_optimizer
from .trainer import CheckpointManager, TrainState, make_train_step

NOT_PORTED = "is not ported yet (ROADMAP.md queue A)"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_batch_len", type=int, default=200_000)
    p.add_argument("--vae_channel", type=int, nargs=5,
                   default=[32, 128, 512, 512, 4])
    p.add_argument("--unet_channel", type=int, nargs=4,
                   default=[4, 320, 640, 960])
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--vae_scale", type=float, default=0.1428)
    p.add_argument("--ddpm_num_steps", type=int, default=1000)
    p.add_argument("--ddpm_beta_schedule", type=str, default="scaled_linear")
    p.add_argument("--prediction_type", type=str, default="epsilon",
                   choices=["epsilon", "sample"])
    p.add_argument("--time_embedding_norm", type=str, default="default",
                   choices=["default", "scale_shift"])
    p.add_argument("--group", type=int, default=32)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--with_attn", action="store_true", default=True)
    p.add_argument("--attn_max_len", type=int, default=0,
                   help="per-instance attention packing length (0 = derive "
                        "from the latent capacity)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--total_steps", type=int, default=100_000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--steps", type=int, default=0, help="hard step cap (0=off)")
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--ckpt_dir", type=str, default="ckpt_diffusion")
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--input_capacity", type=int, default=65536)
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--noise_point_mode", default="none",
                   choices=["none", "uniform", "all"])
    p.add_argument("--noise_point_max", type=int, default=64)
    p.add_argument("--noise_near", action="store_true")
    p.add_argument("--no_vae", action="store_true")
    p.add_argument("--val_every", type=int, default=0)
    p.add_argument("--viz_dir", type=str, default="viz_diffusion")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def check_ported(cfg) -> None:
    if cfg.noise_point_mode != "none" or cfg.noise_near:
        raise NotImplementedError(
            f"noise-point augmentation (diffusion/noise_points.py) {NOT_PORTED}")
    if cfg.val_every > 0:
        raise NotImplementedError(f"the sampling validation {NOT_PORTED}")
    if cfg.remat:
        raise NotImplementedError(f"the UNet's remat {NOT_PORTED}")
    if cfg.data is not None and not cfg.synthetic:
        raise NotImplementedError(f"ModelNet40Dataset {NOT_PORTED}")


def load_vae_checkpoint(vae, directory: str, device) -> int:
    """Load the latest ``train.vae`` checkpoint of ``directory`` into
    ``vae``; returns its step."""
    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no train.vae checkpoint in {directory}")
    payload = torch.load(mgr.path(step), map_location=device,
                         weights_only=True)
    vae.load_state_dict(payload["model"])
    return step


def build_loss_fn(vae, scheduler, *, input_capacity: int, batch_size: int,
                  resolution: int, vae_scale: float, prediction_type: str,
                  no_vae: bool, device):
    """``loss_fn(model, batch, generator=None, timesteps=None, noise=None)
    -> (loss, aux)`` of `examples/train_diffusion.py`: ``batch`` is a
    collated ``(cpad, valid)`` (numpy or tensors), ``model`` the
    ``ModuleDict`` of the UNet and the NLL; the frozen ``vae`` encodes."""
    dev = torch.device(device)

    def loss_fn(model, batch, generator=None, timesteps=None, noise=None):
        cpad, valid = (torch.as_tensor(np.asarray(a), device=dev)
                       for a in batch)
        feats = torch.ones((input_capacity, 1), device=dev) * valid[:, None]
        st = sparse_tensor(cpad, feats, capacity=input_capacity,
                           batch_size=batch_size, valid=valid,
                           extent=(resolution,) * 3)
        if no_vae:
            latent = st  # diffuse occupancy features directly
        else:
            vae.eval()
            with torch.no_grad():
                mean, _ = vae.encode(st)
            latent = mean.with_features(mean.features * vae_scale)
        return diffusion_training_loss(
            model["unet"], scheduler, latent, nll_params=model["nll"],
            resolution=resolution, prediction_type=prediction_type,
            timesteps=timesteps, noise=noise, generator=generator)

    return loss_fn


def setup(cfg, device=None) -> SimpleNamespace:
    """The models, optimizer, state, loss and step function of a run of
    ``cfg`` (``parse_args``) on ``device`` (default: the card), before any
    checkpoint is restored."""
    check_ported(cfg)
    dev = resolve_device(device)
    vae, unet = generation_models(
        input_capacity=cfg.input_capacity, batch_size=cfg.batch_size,
        vae_channel=cfg.vae_channel, unet_channel=cfg.unet_channel,
        group=cfg.group, attn_max_len=cfg.attn_max_len,
        time_embedding_norm=cfg.time_embedding_norm, device=dev,
        seed=cfg.seed)
    if cfg.vae_ckpt:
        load_vae_checkpoint(vae, cfg.vae_ckpt, dev)
    vae.requires_grad_(False)
    model = torch.nn.ModuleDict({"unet": unet,
                                 "nll": CoordNLLParams(device=dev)})
    sched = DDPMScheduler.create(cfg.ddpm_num_steps,
                                 beta_schedule=cfg.ddpm_beta_schedule,
                                 prediction_type=cfg.prediction_type)
    state = TrainState(model, diffusion_optimizer(
        model.parameters(), cfg.lr, cfg.warmup, cfg.total_steps))
    loss_fn = build_loss_fn(
        vae, sched, input_capacity=cfg.input_capacity,
        batch_size=cfg.batch_size, resolution=cfg.resolution,
        vae_scale=cfg.vae_scale, prediction_type=cfg.prediction_type,
        no_vae=cfg.no_vae, device=dev)
    return SimpleNamespace(device=dev, vae=vae, unet=unet, model=model,
                           scheduler=sched, state=state, loss_fn=loss_fn,
                           step_fn=make_train_step(loss_fn))


def main(argv=None) -> int:
    cfg = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("train_diffusion")
    run = setup(cfg, cfg.device)
    log.info("unet params: %d", sum(p.numel() for p in run.unet.parameters()))
    ckpt = CheckpointManager(cfg.ckpt_dir)
    state = ckpt.restore(run.state)
    log.info("resumed at step %d", state.step)
    np_rng = np.random.RandomState(cfg.seed)
    ds = SyntheticShapes(resolution=cfg.resolution, num_samples=256)
    gen = make_generator(cfg.seed, run.device)
    t0 = time.time()
    while True:
        for samples in batch_iterator(ds, cfg.batch_size, np_rng):
            cpad, valid, _, _ = collate_pointclouds(
                [s["coords"] for s in samples], cfg.input_capacity,
                cfg.max_batch_len)
            loss, aux = run.step_fn(state, (cpad, valid), gen)
            step = state.step
            if step % 10 == 0:
                log.info("step %d loss %.5f denoise %.5f (%.2f s/step)",
                         step, float(loss), float(aux["denoise_loss"]),
                         (time.time() - t0) / 10)
                t0 = time.time()
            if step % cfg.save_every == 0:
                ckpt.save(step, state)
            if cfg.steps and step >= cfg.steps:
                ckpt.save(step, state)
                log.info("done (step cap) loss %.5f denoise %.5f nll %.5f",
                         float(loss), float(aux["denoise_loss"]),
                         float(aux["nll_loss"]))
                return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
