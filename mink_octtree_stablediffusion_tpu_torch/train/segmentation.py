"""Indoor semantic segmentation: the counterpart of
`examples/segmentation_indoor.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.segmentation \\
        --steps 100
    python -m mink_octtree_stablediffusion_tpu_torch.train.segmentation \\
        --device cpu --model MinkUNet14 --resolution 16 \\
        --voxels_per_room 256 --steps 2

Same flags and defaults as the JAX example (MinkUNet34C, resolution 32,
batch 2, 2,048 voxels a room, Adam at lr 1e-3, seed 42; ``--synthetic`` is
accepted and is the only data), plus ``--device`` (default: the card).
Each step draws fresh rooms (``make_room``: floor, wall and furniture
voxels labelled 0/1/2, their normalised coordinates plus noise as colour
features), deduplicates the voxels on a bounded grid and reduces the
features and the labels with the same first-occurrence rule (so rows stay
aligned), and takes the per-voxel cross-entropy masked to the valid,
labelled voxels, then one Adam step.  Without ``--steps`` it runs on, as
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
import torch.nn.functional as F

from .. import models
from ..ops.coords import batched_coordinates_np, make_grid, pad_to_capacity
from ..ops.reduce import reduce_by_inverse
from ..tensor import SparseTensor
from ..utils.device import resolve_device
from .optim import vae_optimizer
from .trainer import TrainState, make_train_step

log = logging.getLogger("segmentation")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--voxels_per_room", type=int, default=2048)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--model", default="MinkUNet34C",
                   choices=["MinkUNet14", "MinkUNet18", "MinkUNet34C"])
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def make_room(rng: np.random.RandomState, res: int = 32, n: int = 2048):
    """floor (0) / wall (1) / furniture (2) voxels with colour-like
    features → (coords int32 [n, 3], feats float32 [n, 3], labels int32
    [n]); the draws are the example's, in its order."""
    n3 = n // 3
    floor = np.stack([rng.randint(0, res, n3), rng.randint(0, res, n3),
                      np.zeros(n3, np.int64)], 1)
    wall = np.stack([np.zeros(n3, np.int64), rng.randint(0, res, n3),
                     rng.randint(0, res, n3)], 1)
    box0 = rng.randint(4, res - 8, 3)
    furn = box0 + rng.randint(0, 6, (n - 2 * n3, 3))
    coords = np.concatenate([floor, wall, furn]).astype(np.int32)
    labels = np.concatenate([np.zeros(n3), np.ones(n3),
                             np.full(n - 2 * n3, 2)]).astype(np.int32)
    feats = (coords / res + rng.randn(n, 3) * 0.01).astype(np.float32)
    return coords, feats, labels


def collate(rng: np.random.RandomState, *, batch_size: int, resolution: int,
            voxels_per_room: int):
    """``batch_size`` fresh rooms → (cpad, valid, feats, labels) in a
    buffer of ``batch_size · voxels_per_room`` rows (labels -1 on
    padding)."""
    cap = batch_size * voxels_per_room
    rooms = [make_room(rng, resolution, voxels_per_room)
             for _ in range(batch_size)]
    coords = batched_coordinates_np([r[0] for r in rooms])
    cpad, valid = pad_to_capacity(coords, cap)
    feats = np.zeros((cap, 3), np.float32)
    labels = np.full((cap,), -1, np.int32)
    n = min(len(coords), cap)
    feats[:n] = np.concatenate([r[1] for r in rooms])[:n]
    labels[:n] = np.concatenate([r[2] for r in rooms])[:n]
    return cpad, valid, feats, labels


def build(cpad, valid, feats, labels, *, batch_size: int, resolution: int,
          device):
    """Deduplicate the voxels on a bounded grid (the fused conv route);
    features and labels reduced with the same first-occurrence rule →
    (SparseTensor, per-row labels, -1 off the grid)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)
    cpad, valid, feats, labels = t(cpad), t(valid), t(feats), t(labels)
    cap = cpad.shape[0]
    grid, inverse, _ = make_grid(cpad, valid, cap, batch_size=batch_size,
                                 extent=(resolution,) * 3)
    f = reduce_by_inverse(feats, inverse, valid, cap, "first")
    lab = reduce_by_inverse(labels[:, None].float(), inverse, valid, cap,
                            "first")
    st = SparseTensor(grid=grid, features=f).mask_features()
    return st, torch.where(grid.valid, lab[:, 0].to(torch.int32), -1)


def masked_cross_entropy(out: SparseTensor, labels: torch.Tensor):
    """Cross-entropy and accuracy over the valid, labelled rows."""
    mask = out.valid & (labels >= 0)
    n = mask.sum().clamp(min=1)
    ce = F.cross_entropy(out.features, labels.clamp(min=0).long(),
                         reduction="none")
    loss = torch.where(mask, ce, 0.0).sum() / n
    acc = (mask & (out.features.argmax(-1) == labels)).sum() / n
    return loss, acc


def build_loss_fn(*, batch_size: int, resolution: int, device):
    """``loss_fn(model, batch) -> (loss, {"acc"})`` for a collated
    ``(cpad, valid, feats, labels)``."""

    def loss_fn(model, batch):
        st, labels = build(*batch, batch_size=batch_size,
                           resolution=resolution, device=device)
        loss, acc = masked_cross_entropy(model(st), labels)
        return loss, {"acc": acc}

    return loss_fn


def main(argv=None) -> dict:
    cfg = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(cfg.device)
    rng_np = np.random.RandomState(cfg.seed)
    b = cfg.batch_size
    net = getattr(models, cfg.model)(
        out_channels=3, input_capacity=b * cfg.voxels_per_room, device=dev,
        seed=cfg.seed)
    log.info("params: %d", sum(p.numel() for p in net.parameters()))
    state = TrainState(net, vae_optimizer(net.parameters(), cfg.lr))
    step_fn = make_train_step(build_loss_fn(
        batch_size=b, resolution=cfg.resolution, device=dev))
    t0 = time.time()
    while True:
        loss, aux = step_fn(state, collate(
            rng_np, batch_size=b, resolution=cfg.resolution,
            voxels_per_room=cfg.voxels_per_room))
        step = state.step
        if step % 5 == 0 or (cfg.steps and step >= cfg.steps):
            log.info("step %d loss %.4f acc %.3f (%.2f s/step)", step,
                     float(loss), float(aux["acc"]), (time.time() - t0) / 5)
            t0 = time.time()
        if cfg.steps and step >= cfg.steps:
            out = {"final_loss": float(loss), "acc": float(aux["acc"])}
            print(json.dumps(out), flush=True)
            return out


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
