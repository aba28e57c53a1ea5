"""ModelNet40-style classification: the counterpart of
`examples/classification_modelnet40.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.classification \\
        --steps 100
    python -m mink_octtree_stablediffusion_tpu_torch.train.classification \\
        --device cpu --network pointnet --resolution 32 --num_points 128 \\
        --batch_size 2 --steps 2

Same flags and defaults as the JAX example (``--network minkfcnn``,
``minksplatfcnn``, ``pointnet`` or ``minkpointnet``, the last two both the
TensorField `MinkowskiPointNet` as there; resolution 64, batch 8, 2,048
points a shape, voxel size 0.05, Adam at lr 1e-3, seed 42, 50 epochs), plus
``--device`` (default: the card).  The data are 256 training and 64
held-out `SyntheticShapes` (seed 777); each shape's points, normalised to
the unit sphere, are the features, and ``(x + 1) / voxel_size`` the
coordinates, on a bounded extent so that the convs take the fused route.
The voxel buffer holds ``batch_size · num_points`` rows.  A step is the
cross-entropy of the logits in ``.train()`` (BatchNorm moves its running
statistics; no dropout, as the example passes no ``dropout_rng``) and one
Adam step.  With ``--steps`` the run stops there, scores the held-out
shapes in ``.eval()`` and prints ``{"final_loss", "val_acc"}``.  With
``--data <root>`` (and no ``--synthetic``) the shapes are ModelNet40's
meshes, its ``train`` split for training and its ``test`` split held out,
over 40 classes; as the example, the run first reads the first batch's
samples, so that a mesh dataset's shared generator draws in the example's
order.
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

from ..data import (ModelNet40Dataset, SyntheticShapes, batch_iterator,
                    collate_fields)
from ..models import MinkowskiFCNN, MinkowskiPointNet, MinkowskiSplatFCNN
from ..tensor import TensorField
from ..utils.device import resolve_device
from .optim import vae_optimizer
from .trainer import TrainState, make_train_step

log = logging.getLogger("classification")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", type=str, default="minkfcnn",
                   choices=["minkfcnn", "minksplatfcnn", "pointnet",
                            "minkpointnet"])
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_points", type=int, default=2048)
    p.add_argument("--voxel_size", type=float, default=0.05)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--max_epochs", type=int, default=50)
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--ckpt_dir", type=str, default="ckpt_cls")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def build_model(network: str, n_classes: int, capacity: int, device,
                seed: int = 0) -> torch.nn.Module:
    if network == "minkfcnn":
        return MinkowskiFCNN(out_channel=n_classes, voxel_capacity=capacity,
                             device=device, seed=seed)
    if network == "minksplatfcnn":
        return MinkowskiSplatFCNN(out_channel=n_classes,
                                  voxel_capacity=capacity, device=device,
                                  seed=seed)
    return MinkowskiPointNet(out_channel=n_classes, device=device, seed=seed)


def collate(samples, *, resolution: int, num_points: int, voxel_size: float,
            capacity: int):
    """→ (cpad, valid, fpad, labels): each shape's first ``num_points``
    points, normalised to [-1, 1], as features; ``(x + 1) / voxel_size``
    as continuous coordinates."""
    unit = [(s["xyz"][:num_points] / resolution * 2.0 - 1.0
             ).astype(np.float32) for s in samples]
    coords = [(u + 1.0) / voxel_size for u in unit]
    cpad, valid, fpad = collate_fields(coords, unit, capacity)
    labels = np.array([s["label"] for s in samples], np.int64)
    return cpad, valid, fpad, labels


def field_extent(voxel_size: float):
    return (int(2.0 / voxel_size) + 1,) * 3


def build_field(cpad, valid, fpad, *, batch_size: int, extent, device
                ) -> TensorField:
    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)
    return TensorField(coordinates=t(cpad), features=t(fpad), valid=t(valid),
                       batch_size=batch_size, extent=extent)


def build_loss_fn(*, batch_size: int, extent, device):
    """``loss_fn(model, batch, generator=None) -> (loss, {"acc"})`` for a
    collated ``(cpad, valid, fpad, labels)``: mean cross-entropy."""

    def loss_fn(model, batch, generator=None):
        cpad, valid, fpad, labels = batch
        field = build_field(cpad, valid, fpad, batch_size=batch_size,
                            extent=extent, device=device)
        logits = model(field, generator)
        labels = torch.as_tensor(np.asarray(labels), device=device).long()
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"acc": acc}

    return loss_fn


@torch.no_grad()
def evaluate(model, ds_val, collate_fn, *, batch_size: int, extent,
             device) -> float:
    """Held-out accuracy in ``.eval()``, over whole batches."""
    model.eval()
    correct = total = 0
    for i in range(0, len(ds_val) - batch_size + 1, batch_size):
        cpad, valid, fpad, labels = collate_fn(
            [ds_val[j] for j in range(i, i + batch_size)])
        logits = model(build_field(cpad, valid, fpad, batch_size=batch_size,
                                   extent=extent, device=device))
        correct += int((logits.argmax(-1).cpu().numpy() == labels).sum())
        total += len(labels)
    return correct / max(total, 1)


def main(argv=None) -> dict:
    cfg = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(cfg.device)
    np_rng = np.random.RandomState(cfg.seed)
    if cfg.synthetic or cfg.data is None:
        ds = SyntheticShapes(resolution=cfg.resolution, num_samples=256,
                             points_per_shape=cfg.num_points)
        ds_val = SyntheticShapes(resolution=cfg.resolution, num_samples=64,
                                 points_per_shape=cfg.num_points, seed=777)
        n_classes = len(ds.CLASSES)
    else:
        ds = ModelNet40Dataset(cfg.data, "train", cfg.resolution)
        ds_val = ModelNet40Dataset(cfg.data, "test", cfg.resolution)
        n_classes = 40
    b, cap = cfg.batch_size, cfg.batch_size * cfg.num_points
    # the example's initial reads, which move a mesh dataset's generator
    [ds[i] for i in range(b)]
    extent = field_extent(cfg.voxel_size)
    net = build_model(cfg.network, n_classes, cap, dev, cfg.seed)
    log.info("params: %d", sum(p.numel() for p in net.parameters()))
    state = TrainState(net, vae_optimizer(net.parameters(), cfg.lr))
    step_fn = make_train_step(build_loss_fn(batch_size=b, extent=extent,
                                            device=dev))

    def collate_fn(samples):
        return collate(samples, resolution=cfg.resolution,
                       num_points=cfg.num_points, voxel_size=cfg.voxel_size,
                       capacity=cap)

    def score():
        return evaluate(net, ds_val, collate_fn, batch_size=b, extent=extent,
                        device=dev)

    t0 = time.time()
    for epoch in range(cfg.max_epochs):
        for samples in batch_iterator(ds, b, np_rng):
            loss, aux = step_fn(state, collate_fn(samples))
            step = state.step
            if step % 10 == 0:
                log.info("epoch %d step %d loss %.4f acc %.3f (%.2f s/step)",
                         epoch, step, float(loss), float(aux["acc"]),
                         (time.time() - t0) / 10)
                t0 = time.time()
            if cfg.steps and step >= cfg.steps:
                out = {"final_loss": float(loss), "val_acc": score()}
                log.info("done (step cap); final loss %.4f val_acc %.4f",
                         out["final_loss"], out["val_acc"])
                print(json.dumps(out), flush=True)
                return out
        log.info("epoch %d complete: val_acc %.4f", epoch, score())
    return {"final_loss": float(loss), "val_acc": score()}


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
