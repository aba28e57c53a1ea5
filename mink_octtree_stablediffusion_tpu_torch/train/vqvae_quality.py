"""VQ-VAE quality to a metric: the counterpart of `scripts/vqvae_quality.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.vqvae_quality \\
        --resolution 64 --points 32768 --input_capacity 65536 \\
        --vae_channel 32 128 512 512 4 --steps 2000
    python -m mink_octtree_stablediffusion_tpu_torch.train.vqvae_quality \\
        --device cpu --resolution 16 --points 512 --input_capacity 1024 \\
        --steps 3

Reconstruction IoU, codebook health (perplexity, active-code fraction) and
the straight-through losses of the VQ-VAE (`models/vqvae.py`).  Same flags
and defaults as the script (resolution 32, batch 4, 4,096 points a shape,
8,192 input rows, channels (16, 32, 64, 64, 4) with `serve.capacities`'
schedule, 512 codes, 1,500 steps, lr 1e-3, seed 0), plus ``--device``
(default: the card).  Three protocols:

- default: overfit one fixed batch of `SyntheticShapes` and report the
  eval-mode reconstruction IoU on it;
- ``--generalize``: train on batches drawn (``RandomState(seed + 1)``) from
  ``--train_shapes`` `ProceduralShapes` and report the held-out IoU on the
  ``--val_shapes`` of the val split;
- ``--stream`` (implies ``--generalize``): every training batch made on the
  device by `data.procedural_batch` from one ``torch.Generator`` seeded
  ``seed + 177``, which each batch advances, where the script folds a batch
  counter into ``PRNGKey(seed + 177)``: the shapes follow the same
  distribution, not the same draws.

``--ema`` / ``--ema_decay`` move the codebook by exponential moving
averages instead of its loss, and ``--restart_dead`` re-seeds dying codes
from the batch's encoder outputs (drawn from the training generator).  A
step's loss is the per-level occupancy BCE plus the VQ loss, clipped at
1.0, Adam on a 20-step warmup-cosine schedule.  The codes of the valid
latent rows of every eval batch give the perplexity and the active-code
fraction (``codebook_stats``).  ``--viz_dir`` renders one input and its
reconstruction.  Prints the script's lines and, last, its JSON line, which
``main`` returns; ``main(argv, on_step)`` calls ``on_step("vq", step,
loss, aux)`` after every step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..data import (ProceduralShapes, SyntheticShapes, collate_pointclouds,
                    procedural_batch)
from ..models import VQVAE
from ..serve import capacities
from ..utils.device import make_generator, resolve_device
from . import vqvae as train_vqvae
from .generalize import build_input, mean_iou, voxel_sets
from .optim import canvas_vae_optimizer
from .trainer import TrainState, make_train_step


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--points", type=int, default=4096)
    p.add_argument("--input_capacity", type=int, default=8192)
    p.add_argument("--vae_channel", type=int, nargs=5,
                   default=[16, 32, 64, 64, 4])
    p.add_argument("--num_embeddings", type=int, default=512)
    p.add_argument("--ema", action="store_true",
                   help="EMA codebook updates instead of the codebook-"
                        "gradient loss")
    p.add_argument("--ema_decay", type=float, default=0.99)
    p.add_argument("--restart_dead", action="store_true",
                   help="re-seed dying codes from batch encoder outputs")
    p.add_argument("--stream", action="store_true",
                   help="fresh on-device procedural batches every step "
                        "(data/device_shapes.py) — the streaming protocol")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--generalize", action="store_true",
                   help="train on the ProceduralShapes distribution and "
                        "report held-out val reconstruction IoU")
    p.add_argument("--train_shapes", type=int, default=512)
    p.add_argument("--val_shapes", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--viz_dir", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    cfg = p.parse_args(argv)
    if cfg.stream:
        cfg.generalize = True  # streaming implies the held-out protocol
    return cfg


def codebook_stats(codes: np.ndarray, num_embeddings: int) -> tuple:
    """(perplexity, active-code fraction) of the codes taken: exp of the
    entropy of their histogram, and the share of the codebook taken at
    least once."""
    hist = np.bincount(codes, minlength=num_embeddings).astype(np.float64)
    pk = hist / max(hist.sum(), 1.0)
    nz = pk[pk > 0]
    return float(np.exp(-np.sum(nz * np.log(nz)))), float(np.mean(hist > 0))


@torch.no_grad()
def reconstruct(net: VQVAE, batch, *, input_capacity: int, batch_size: int,
                resolution: int, device):
    """(input, decoded, codes of the valid latent rows) of one batch
    through the VQ-VAE in eval mode."""
    cpad, valid = (torch.as_tensor(a, device=device) for a in batch[:2])
    st = build_input((cpad, valid, valid[:, None].float()),
                     input_capacity=input_capacity, batch_size=batch_size,
                     resolution=resolution, device=device)
    was = net.training
    net.eval()
    _, _, sout, ze, idx, _ = net(st, st.grid)
    net.train(was)
    return st, sout, idx[ze.valid].cpu().numpy()


def main(argv=None, on_step=None) -> dict:
    cfg = parse_args(argv)
    dev = resolve_device(cfg.device)
    res, b, cap = cfg.resolution, cfg.batch_size, cfg.input_capacity
    np_rng = np.random.RandomState(cfg.seed + 1)
    if cfg.generalize:
        train_ds = ProceduralShapes(resolution=res,
                                    num_samples=cfg.train_shapes,
                                    points_per_shape=cfg.points,
                                    seed=cfg.seed, split="train")
        val_ds = ProceduralShapes(resolution=res, num_samples=cfg.val_shapes,
                                  points_per_shape=cfg.points, seed=cfg.seed,
                                  split="val")
        # (the stream draws its own shapes: the pool is not read)
        train_coords = [] if cfg.stream else [
            train_ds[i]["coords"] for i in range(cfg.train_shapes)]
        val_coords = [val_ds[i]["coords"] for i in range(cfg.val_shapes)]
    else:
        ds = SyntheticShapes(resolution=res, num_samples=b,
                             points_per_shape=cfg.points)
        train_coords = [ds[i]["coords"] for i in range(b)]
        val_coords = train_coords  # overfit protocol: eval on the train batch

    def collate(coords_list):
        return collate_pointclouds(coords_list, cap)[:2]

    if cfg.stream:
        stream_gen = make_generator(cfg.seed + 177, dev)

        def train_batch():
            return procedural_batch(stream_gen, b, cfg.points, res, cap)[:2]
    else:
        def train_batch():
            if cfg.generalize:
                idx = np_rng.randint(0, len(train_coords), b)
                return collate([train_coords[i] for i in idx])
            return collate(train_coords)

    val_batches = [collate(val_coords[i:i + b])
                   for i in range(0, len(val_coords) - b + 1, b)]

    enc_caps, dec_caps = capacities(cap)
    net = VQVAE(channels=tuple(cfg.vae_channel),
                num_embeddings=cfg.num_embeddings, ema=cfg.ema,
                ema_decay=cfg.ema_decay, restart_dead=cfg.restart_dead,
                encoder_capacities=enc_caps, decoder_capacities=dec_caps,
                device=dev, seed=cfg.seed)
    print("vqvae params:", sum(p.numel() for p in net.parameters()),
          flush=True)
    state = TrainState(net, canvas_vae_optimizer(net.parameters(), cfg.lr,
                                                 cfg.steps))
    step_fn = make_train_step(train_vqvae.build_loss_fn(
        input_capacity=cap, batch_size=b, resolution=res, device=dev))
    gen = make_generator(cfg.seed, dev)
    t0 = time.time()
    bce = vq = None
    for step in range(1, cfg.steps + 1):
        loss, aux = step_fn(state, train_batch(), gen)
        if on_step is not None:
            on_step("vq", step, loss, aux)
        if step % 100 == 0 or step == cfg.steps:
            bce, vq = float(aux["bce"]), float(aux["vq"])
            print(f"step {step} loss {float(loss):.5f} bce {bce:.5f} vq "
                  f"{vq:.5f} ({(time.time() - t0) / step:.2f} s/step)",
                  flush=True)

    sizes = dict(input_capacity=cap, batch_size=b, resolution=res,
                 device=dev)
    ious, all_idx = [], []
    for vb in val_batches:
        st_in, st_rec, codes = reconstruct(net, vb, **sizes)
        ious.append(mean_iou(voxel_sets(st_in), voxel_sets(st_rec)))
        all_idx.append(codes)
    rec_iou = float(np.mean(ious))
    perplexity, active = codebook_stats(np.concatenate(all_idx),
                                        cfg.num_embeddings)
    label = "HELD-OUT val" if cfg.generalize else "overfit eval"
    print(f"{label} reconstruction IoU: {rec_iou:.4f}", flush=True)
    print(f"codebook: perplexity {perplexity:.1f} / {cfg.num_embeddings}, "
          f"active-code fraction {active:.3f}", flush=True)

    if cfg.viz_dir:
        from ..utils.viz import render_pointclouds, sparse_tensor_clouds

        st_in, st_rec, _ = reconstruct(net, val_batches[0], **sizes)
        tag = "_gen" if cfg.generalize else ""
        path = render_pointclouds(
            [sparse_tensor_clouds(st_in, 1)[0],
             sparse_tensor_clouds(st_rec, 1)[0]],
            os.path.join(cfg.viz_dir, f"vqvae_quality{tag}.png"),
            titles=["data", "vq reconstruction"], resolution=res)
        print("render:", path, flush=True)

    out = {"reconstruction_iou": rec_iou, "bce": bce, "vq_loss": vq,
           "codebook_perplexity": perplexity, "active_code_fraction": active,
           "generalize": cfg.generalize}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
