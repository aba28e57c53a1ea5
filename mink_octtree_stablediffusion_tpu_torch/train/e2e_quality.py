"""Two-phase generative-quality check: the counterpart of
`scripts/e2e_quality.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.e2e_quality
    python -m mink_octtree_stablediffusion_tpu_torch.train.e2e_quality \\
        --device cpu --resolution 16 --steps_vae 3 --steps_diff 3 \\
        --sample_steps 2

VAE overfit → diffusion overfit → sample → decode, each with a voxel-IoU
metric.  Same flags and defaults as the script (resolution 32, batch 4,
4,096 surface points a shape, 8,192 input rows, VAE (16, 32, 64, 64, 4)
with `serve.capacities`' schedule, UNet (4, 64, 128, 192) with group 16,
1,500 VAE and 2,000 diffusion steps, 50 sampling steps, seed 0), plus
``--device`` (default: the card).

- Phase 1 overfits the VAE on one fixed batch of `SyntheticShapes`
  (clipping at 1.0, Adam on a 20-step warmup-cosine schedule,
  ``optim.canvas_vae_optimizer``; ``kld_weight`` 1e-6) and reports the
  eval-mode reconstruction IoU (``reconstruction_iou``).
- Phase 2 overfits latent diffusion on the frozen VAE's latents (the
  encoder's mean in eval mode, scaled by ``--vae_scale``): a UNet with
  ``attn_max_len`` = 1.5 latent rows an instance rounded up to 128 and
  down capacities ``latent_cap`` / 2, 4, 8, ``DDPMScheduler`` with
  ``--prediction_type``, AdamW or Adafactor (``--diff_opt``) on a 100-step
  warmup, ``--remat``, and the loss with the coordinate NLL
  (``CoordNLLParams``).
- Phase 3 samples from N(0,1) on the batch's latent coordinates
  (``--sample_steps`` DDPM steps, the noise from ``seed + 7``), decodes in
  eval mode and reports the generation IoU against the training shapes
  (``generation_iou``); ``--viz_dir`` renders data, reconstruction and
  sample to ``e2e_quality.png``.

Prints the script's lines and, last, its JSON line (``bce``,
``reconstruction_iou``, ``generation_iou``), which ``main`` returns;
``main(argv, on_step)`` calls ``on_step(phase, step, loss, aux)`` after
every training step (phase "vae" or "diff").  JAX's random streams are
not reproduced: the draws come from ``torch`` generators seeded from
``--seed``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..data import SyntheticShapes, collate_pointclouds
from ..diffusion import CoordNLLParams, DDPMScheduler, sample_latent
from ..models.unet import UNet
from ..models.vae import VAE
from ..serve import capacities
from ..utils.device import make_generator, resolve_device
from . import diffusion as train_diffusion
from . import vae as train_vae
from .generalize import build_input, mean_iou, reconstruct
from .generalize import voxel_sets as _voxel_sets
from .optim import (adafactor_diffusion_optimizer, canvas_vae_optimizer,
                    diffusion_optimizer)
from .trainer import TrainState, make_train_step


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--points", type=int, default=4096,
                   help="surface samples per shape (raise with resolution "
                        "so the voxel shell is fully covered)")
    p.add_argument("--input_capacity", type=int, default=8192)
    p.add_argument("--vae_channel", type=int, nargs=5,
                   default=[16, 32, 64, 64, 4])
    p.add_argument("--unet_channel", type=int, nargs=4,
                   default=[4, 64, 128, 192])
    p.add_argument("--steps_vae", type=int, default=1500)
    p.add_argument("--steps_diff", type=int, default=2000)
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--vae_scale", type=float, default=0.1428)
    p.add_argument("--lr_vae", type=float, default=1e-3)
    p.add_argument("--lr_diff", type=float, default=2e-4)
    p.add_argument("--group", type=int, default=16)
    p.add_argument("--prediction_type",
                   choices=["epsilon", "sample", "v_prediction"],
                   default="epsilon")
    p.add_argument("--diff_opt", choices=["adamw", "adafactor"],
                   default="adamw")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize UNet stacks in the backward pass")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--viz_dir", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def voxel_sets(st, stride: int = 1) -> dict:
    """Per-instance sets of voxel tuples (host side)."""
    return _voxel_sets(st)


def iou(sets_a: dict, sets_b: dict) -> float:
    """Mean per-instance intersection-over-union of two voxel-set dicts."""
    return mean_iou(sets_a, sets_b)


def fixed_batch(cfg):
    """The script's overfit batch: ``batch_size`` `SyntheticShapes`
    collated into ``input_capacity`` rows → (cpad, valid, feats)."""
    ds = SyntheticShapes(resolution=cfg.resolution,
                         num_samples=cfg.batch_size,
                         points_per_shape=cfg.points)
    return collate_pointclouds([ds[i]["coords"]
                                for i in range(cfg.batch_size)],
                               cfg.input_capacity)[:3]


def overfit_vae(cfg, dev) -> VAE:
    """The overfit scripts' VAE: ``vae_channel`` with `serve.capacities`'
    schedule for ``input_capacity`` rows, random weights from ``seed``."""
    enc_caps, dec_caps = capacities(cfg.input_capacity)
    return VAE(channels=tuple(cfg.vae_channel), encoder_capacities=enc_caps,
               decoder_capacities=dec_caps, device=dev, seed=cfg.seed)


def train_vae_overfit(cfg, vae: VAE, batch, dev, line, log_every: int,
                      on_step=None):
    """Phase 1 of the overfit scripts: ``vae`` trained ``steps_vae`` steps
    on ``batch`` (clip 1.0 + Adam on warmup-cosine, ``kld_weight`` 1e-6),
    printing ``line(step, loss, aux, s_per_step)`` every ``log_every``
    steps and at the last; ``on_step("vae", step, loss, aux)`` after every
    step.  Returns the last printed step's BCE."""
    state = TrainState(vae, canvas_vae_optimizer(
        vae.parameters(), cfg.lr_vae, cfg.steps_vae))
    step_fn = make_train_step(train_vae.build_loss_fn(
        input_capacity=cfg.input_capacity, batch_size=cfg.batch_size,
        resolution=cfg.resolution, kld_weight=1e-6, device=dev))
    gen = make_generator(cfg.seed, dev)
    batch = tuple(torch.as_tensor(a, device=dev) for a in batch)
    t0, bce = time.time(), None
    for step in range(1, cfg.steps_vae + 1):
        loss, aux = step_fn(state, batch, gen)
        if on_step is not None:
            on_step("vae", step, loss, aux)
        if step % log_every == 0 or step == cfg.steps_vae:
            bce = float(aux["bce"])
            print(line(step, loss, aux, (time.time() - t0) / step),
                  flush=True)
    return bce


def latent_unet(cfg, latent_cap: int, dev) -> UNet:
    """The script's UNet: ``attn_max_len`` one and a half latent rows an
    instance (rounded up to 128), down capacities latent_cap / 2, 4, 8."""
    b = cfg.batch_size
    attn_max_len = max(-(-latent_cap * 3 // (2 * b) // 128) * 128, 128)
    return UNet(channels=tuple(cfg.unet_channel), group=cfg.group,
                attn_max_len=attn_max_len, remat=cfg.remat,
                down_capacities=(max(latent_cap // 2, 16),
                                 max(latent_cap // 4, 8),
                                 max(latent_cap // 8, 8)),
                device=dev, seed=cfg.seed + 1)


@torch.no_grad()
def generate(vae: VAE, unet: UNet, scheduler, st, *, vae_scale: float,
             sample_steps: int, seed: int):
    """Phase 3: the frozen VAE's latent of ``st`` as the template, its
    features denoised from N(0,1) (``seed``) by the UNet in eval mode,
    then decoded in eval mode against ``st``'s grid."""
    vae.eval()
    unet.eval()
    mean, _ = vae.encode(st)
    template = mean.with_features(mean.features * vae_scale)
    z = sample_latent(unet, scheduler, template,
                      num_inference_steps=sample_steps,
                      generator=make_generator(seed, st.C.device))
    _, _, sout = vae.decode(z.with_features(z.features / vae_scale),
                            st.grid)
    return sout


def main(argv=None, on_step=None) -> dict:
    cfg = parse_args(argv)
    dev = resolve_device(cfg.device)
    cap, b = cfg.input_capacity, cfg.batch_size
    batch = fixed_batch(cfg)
    sizes = dict(input_capacity=cap, batch_size=b, resolution=cfg.resolution)
    enc_caps, _ = capacities(cap)
    latent_cap = enc_caps[2]

    # ---- phase 1: VAE overfit ----
    vae = overfit_vae(cfg, dev)
    print("vae params:", sum(p.numel() for p in vae.parameters()),
          flush=True)
    bce = train_vae_overfit(
        cfg, vae, batch, dev, lambda step, loss, aux, sps:
        f"vae step {step} loss {float(loss):.5f} bce {float(aux['bce']):.5f}"
        f" ({sps:.2f} s/step)", 100, on_step)
    st_in, st_rec = reconstruct(vae, batch, device=dev, **sizes)
    rec_iou = iou(voxel_sets(st_in), voxel_sets(st_rec))
    print(f"reconstruction IoU: {rec_iou:.4f}", flush=True)

    # ---- phase 2: diffusion overfit on the frozen latents ----
    vae.requires_grad_(False)
    unet = latent_unet(cfg, latent_cap, dev)
    print("unet params:", sum(p.numel() for p in unet.parameters()),
          flush=True)
    model = torch.nn.ModuleDict({"unet": unet,
                                 "nll": CoordNLLParams(device=dev)})
    make_opt = (adafactor_diffusion_optimizer if cfg.diff_opt == "adafactor"
                else diffusion_optimizer)
    dstate = TrainState(model, make_opt(model.parameters(), cfg.lr_diff,
                                        warmup_steps=100,
                                        total_steps=cfg.steps_diff))
    sched = DDPMScheduler.create(prediction_type=cfg.prediction_type)
    dstep_fn = make_train_step(train_diffusion.build_loss_fn(
        vae, sched, vae_scale=cfg.vae_scale,
        prediction_type=cfg.prediction_type, no_vae=False, device=dev,
        **sizes))
    gen = make_generator(cfg.seed + 1, dev)
    dbatch = tuple(torch.as_tensor(a, device=dev) for a in batch[:2])
    t0 = time.time()
    for step in range(1, cfg.steps_diff + 1):
        loss, aux = dstep_fn(dstate, dbatch, gen)
        if on_step is not None:
            on_step("diff", step, loss, aux)
        if step % 100 == 0 or step == cfg.steps_diff:
            print(f"diff step {step} loss {float(loss):.5f} denoise "
                  f"{float(aux['denoise_loss']):.5f} "
                  f"({(time.time() - t0) / step:.2f} s/step)", flush=True)

    # ---- phase 3: sample + decode + IoU vs the training shapes ----
    st_in2 = build_input(batch, device=dev, **sizes)
    st_gen = generate(vae, unet, sched, st_in2, vae_scale=cfg.vae_scale,
                      sample_steps=cfg.sample_steps, seed=cfg.seed + 7)
    gen_iou = iou(voxel_sets(st_in2), voxel_sets(st_gen))
    print(f"generation IoU (overfit): {gen_iou:.4f}", flush=True)

    if cfg.viz_dir:
        from ..utils.viz import render_pointclouds, sparse_tensor_clouds

        path = render_pointclouds(
            [sparse_tensor_clouds(st_in2, 1)[0],
             sparse_tensor_clouds(st_rec, 1)[0],
             sparse_tensor_clouds(st_gen, 1)[0]],
            os.path.join(cfg.viz_dir, "e2e_quality.png"),
            titles=["data", "reconstruction", "generated"],
            resolution=cfg.resolution)
        print("render:", path, flush=True)

    out = {"bce": bce, "reconstruction_iou": rec_iou,
           "generation_iou": gen_iou}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
