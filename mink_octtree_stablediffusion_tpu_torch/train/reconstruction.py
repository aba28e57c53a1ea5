"""Class-conditional generative reconstruction: the counterpart of
`examples/reconstruction.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.reconstruction \\
        --steps 100
    python -m mink_octtree_stablediffusion_tpu_torch.train.reconstruction \\
        --device cpu --resolution 16 --batch_size 2 --input_capacity 2048 \\
        --num_points 1024 --steps 2

Same flags and defaults as the JAX example (resolution 64, batch 4, SGD
with momentum 0.9 at lr 1e-2, or ``--opt adam``: Adam after a global-norm
clip of 1.0; seed 42, 50 epochs, 65,536 input rows, 32,768 surface points
a shape, an eval every 100 steps), plus ``--device`` (default: the card).
`GenerativeNet` grows each shape from one seed voxel per instance at stride
64 (features: the class one-hot × 10) through six levels whose buffers
hold ``min(batch · 8^(l+1), input_capacity)`` rows, on the bounded extent
``max(resolution, 64)`` so that every level's convs take the fused route.
A step is the mean over the levels of the masked BCE of each level's
occupancy logits against the target's voxels at that stride, in
``.train()`` (the target voxels force-kept).  The eval generates each of
``batch_size`` held-out `SyntheticShapes` (seed 777) from its class seed
in ``.eval()`` (no force-keep) and scores the occupancy IoU of the voxel
sets against its target.  With ``--steps`` the run ends there with one
last eval, an optional render (``--viz_dir``, matplotlib) and a JSON
line ``{"final_bce", "generation_iou"}``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data import SyntheticShapes, batch_iterator, collate_pointclouds
from ..models import GenerativeNet, occupancy_bce
from ..ops.coords import SparseGrid
from ..tensor import SparseTensor, sparse_tensor
from ..utils.device import resolve_device
from .optim import DiffusionOptimizer
from .trainer import TrainState, make_train_step

log = logging.getLogger("reconstruction")
SEED_STRIDE = 2 ** 6  # 6 levels of 2x growth down to stride 1


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--opt", choices=["sgd", "adam"], default="sgd")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--max_epochs", type=int, default=50)
    p.add_argument("--input_capacity", type=int, default=65536)
    p.add_argument("--num_points", type=int, default=32768)
    p.add_argument("--eval_every", type=int, default=100)
    p.add_argument("--viz_dir", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def level_capacities(batch_size: int, input_capacity: int):
    return tuple(min(batch_size * 8 ** (i + 1), input_capacity)
                 for i in range(6))


def make_optimizer(params, opt: str, lr: float):
    """``optax.sgd(lr, momentum=0.9)`` (``torch.optim.SGD`` takes the same
    step: its buffer starts at the first gradient, as optax's trace from
    zero does), or ``optax.chain(clip_by_global_norm(1.0), adam(lr))``."""
    if opt == "adam":
        return DiffusionOptimizer(params, lambda count: lr,
                                  weight_decay=0.0, clip_norm=1.0)
    return torch.optim.SGD(params, lr=lr, momentum=0.9)


def seed_tensor(labels, *, n_classes: int, resolution: int, device
                ) -> SparseTensor:
    """One voxel per instance at the origin at stride 64, its features
    the class one-hot × 10, on the bounded extent."""
    labels = torch.as_tensor(np.asarray(labels), device=device).long()
    b = labels.shape[0]
    coords = torch.cat([torch.arange(b, dtype=torch.int32, device=device
                                     )[:, None],
                        torch.zeros((b, 3), dtype=torch.int32,
                                    device=device)], dim=-1)
    ext = max(resolution, SEED_STRIDE)
    grid = SparseGrid(coords=coords,
                      valid=torch.ones(b, dtype=torch.bool, device=device),
                      stride=(SEED_STRIDE,) * 3, batch_size=b,
                      extent=(ext,) * 3)
    return SparseTensor(grid=grid, features=F.one_hot(
        labels, n_classes).float() * 10.0)


def target_grid(cpad, valid, *, batch_size: int, resolution: int,
                device) -> SparseGrid:
    cpad = torch.as_tensor(np.asarray(cpad), device=device)
    valid = torch.as_tensor(np.asarray(valid), device=device)
    ext = max(resolution, SEED_STRIDE)
    return sparse_tensor(cpad, valid[:, None].float(),
                         capacity=cpad.shape[0], batch_size=batch_size,
                         valid=valid, extent=(ext,) * 3).grid


def build_loss_fn(*, n_classes: int, batch_size: int, resolution: int,
                  device):
    """``loss_fn(model, batch) -> (bce, {"final_voxels"})`` for a batch
    ``(cpad, valid, labels)``."""

    def loss_fn(model, batch):
        cpad, valid, labels = batch
        z = seed_tensor(labels, n_classes=n_classes, resolution=resolution,
                        device=device)
        tg = target_grid(cpad, valid, batch_size=batch_size,
                         resolution=resolution, device=device)
        out_clss, targets, sout = model(z, tg)
        return occupancy_bce(out_clss, targets), {
            "final_voxels": sout.count()}

    return loss_fn


def voxel_sets(coords, valid) -> dict:
    """instance → set of voxel coordinates."""
    out: dict = {}
    for row, ok in zip(np.asarray(coords), np.asarray(valid)):
        if ok:
            out.setdefault(int(row[0]), set()).add(
                tuple(int(x) for x in row[1:]))
    return out


@torch.no_grad()
def generation_iou(model, eval_batch, *, n_classes: int, batch_size: int,
                   resolution: int, device):
    """Generate each eval instance from its class seed in ``.eval()`` →
    (mean occupancy IoU against its target, the generated tensor)."""
    cpad, valid, labels = eval_batch
    model.eval()
    z = seed_tensor(labels, n_classes=n_classes, resolution=resolution,
                    device=device)
    tg = target_grid(cpad, valid, batch_size=batch_size,
                     resolution=resolution, device=device)
    _, _, sout = model(z, tg)
    gen = voxel_sets(sout.grid.coords.cpu(), sout.grid.valid.cpu())
    tgt = voxel_sets(cpad, valid)
    vals = [len(gen.get(i, set()) & tgt[i]) /
            max(len(gen.get(i, set()) | tgt[i]), 1) for i in tgt]
    return float(np.mean(vals)), sout


def main(argv=None) -> dict:
    cfg = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(cfg.device)
    np_rng = np.random.RandomState(cfg.seed)
    ds = SyntheticShapes(resolution=cfg.resolution, num_samples=256,
                         points_per_shape=cfg.num_points)
    n_classes, b, cap = len(ds.CLASSES), cfg.batch_size, cfg.input_capacity
    net = GenerativeNet(in_channels=n_classes,
                        level_capacities=level_capacities(b, cap),
                        device=dev, seed=cfg.seed)
    log.info("params: %d", sum(p.numel() for p in net.parameters()))
    state = TrainState(net, make_optimizer(net.parameters(), cfg.opt,
                                           cfg.lr))
    sizes = dict(n_classes=n_classes, batch_size=b,
                 resolution=cfg.resolution, device=dev)
    step_fn = make_train_step(build_loss_fn(**sizes))
    ds_val = SyntheticShapes(resolution=cfg.resolution, num_samples=b,
                             points_per_shape=cfg.num_points, seed=777)
    eval_samples = [ds_val[i] for i in range(b)]
    ecpad, evalid, _, _ = collate_pointclouds(
        [s["coords"] for s in eval_samples], cap)
    eval_batch = (ecpad, evalid, [s["label"] for s in eval_samples])
    t0 = time.time()
    epochs = cfg.max_epochs if not cfg.steps else \
        max(cfg.max_epochs, -(-cfg.steps // max(len(ds) // b, 1)))
    for epoch in range(epochs):
        for samples in batch_iterator(ds, b, np_rng):
            cpad, valid, _, _ = collate_pointclouds(
                [s["coords"] for s in samples], cap)
            loss, aux = step_fn(state, (cpad, valid,
                                        [s["label"] for s in samples]))
            step = state.step
            if step % 10 == 0:
                log.info("epoch %d step %d bce %.4f voxels %d "
                         "(%.2f s/step)", epoch, step, float(loss),
                         int(aux["final_voxels"]), (time.time() - t0) / 10)
                t0 = time.time()
            if cfg.eval_every and step % cfg.eval_every == 0:
                iou, _ = generation_iou(net, eval_batch, **sizes)
                log.info("step %d eval generation IoU %.4f", step, iou)
            if cfg.steps and step >= cfg.steps:
                iou, sout = generation_iou(net, eval_batch, **sizes)
                log.info("done; final bce %.4f generation IoU %.4f",
                         float(loss), iou)
                if cfg.viz_dir:
                    from ..utils.viz import (render_pointclouds,
                                             sparse_tensor_clouds)
                    path = render_pointclouds(
                        sparse_tensor_clouds(sout, b),
                        os.path.join(cfg.viz_dir, "reconstruction.png"),
                        titles=[f"gen {ds.CLASSES[i]}" for i in range(b)],
                        resolution=cfg.resolution)
                    log.info("render: %s", path)
                out = {"final_bce": float(loss), "generation_iou": iou}
                print(json.dumps(out), flush=True)
                return out
    return {"final_bce": float(loss)}


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
