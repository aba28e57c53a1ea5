"""Data-parallel training of a sparse ResNet classifier: the counterpart of
`examples/multigpu_dp.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.multigpu_dp \\
        --nproc 2 --backend gloo --device cpu --steps 3
    python -m mink_octtree_stablediffusion_tpu_torch.multigpu_dp \\
        --nproc 2 --backend gloo              # two ranks on one GPU
    torchrun --nproc_per_node 4 -m \\
        mink_octtree_stablediffusion_tpu_torch.multigpu_dp --backend nccl

The JAX example's flags and defaults (``--steps`` 5,
``--batch_per_device`` 2, ``--resolution`` 16, ``--capacity`` 1024,
``--lr`` 1e-3; ``--force_cpu`` is ``--device cpu``), plus ``--nproc``
(the ranks this command spawns; under torchrun's environment the process
joins as its rank instead), ``--backend`` (``nccl`` when each rank has a
GPU of its own, ``gloo`` when ranks share one GPU or run on the CPU; the
caller's choice, refused where it cannot work), ``--device`` (default:
the card; rank r takes GPU ``r mod count``), ``--seed``, ``--ckpt_dir``
and ``--save_every``.

Every rank builds ResNet14 (4 classes, stem 64, planes 64–512) with SyncBN
over the group from ``--seed``, takes rank 0's weights, and trains it with
Adam through ``train.make_dp_train_step``: rank r's batch at step s is
``--batch_per_device`` `SyntheticShapes` (resolution ``--resolution``,
512 points) drawn with seed ``s·world + r``, as the example draws device
r's.  Rank 0 logs each step's loss, wall seconds, world size and global
batch, and writes checkpoints (``CheckpointManager``) every
``--save_every`` steps and at the end; every rank resumes from the latest
one.  ``--steps`` caps the step count.  At the end the ranks'
parameters and buffers must be equal bit for bit, else the run fails.
"""

from __future__ import annotations

import argparse
import hashlib
import logging
import os
import sys
import time
from typing import List

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .data import SyntheticShapes, collate_pointclouds
from .models.resnet import ResNet14
from .parallel import (check_backend, free_port, initialize_distributed,
                       rank_device)
from .tensor import sparse_tensor
from .train import (CheckpointManager, TrainState, broadcast_module,
                    make_dp_train_step, vae_optimizer)
from .utils.device import resolve_device

log = logging.getLogger("multigpu_dp")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch_per_device", type=int, default=2)
    p.add_argument("--resolution", type=int, default=16)
    p.add_argument("--capacity", type=int, default=1024)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--force_cpu", action="store_true",
                   help="the same as --device cpu")
    p.add_argument("--nproc", type=int, default=1,
                   help="ranks to spawn (ignored under torchrun)")
    p.add_argument("--backend", choices=("nccl", "gloo"), required=True)
    p.add_argument("--device", type=str, default=None,
                   help="torch device type (default: cuda)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt_dir", type=str, default="ckpt_multigpu_dp")
    p.add_argument("--save_every", type=int, default=500)
    cfg = p.parse_args(argv)
    if cfg.force_cpu:
        cfg.device = "cpu"
    return cfg


def rank_batch(ds, cfg, step: int, rank: int, world: int):
    """Rank ``rank``'s (cpad, valid, feats, labels) at ``step``."""
    r = np.random.RandomState(step * world + rank)
    samples = [ds[int(i)] for i in r.randint(0, len(ds),
                                              cfg.batch_per_device)]
    cpad, valid, feats, _ = collate_pointclouds(
        [s["coords"] for s in samples], cfg.capacity)
    return cpad, valid, feats, np.array([s["label"] for s in samples])


def build_loss_fn(cfg, device):
    """``loss_fn(model, batch) -> (loss, {})``: softmax cross-entropy of
    the logits against the integer labels, averaged over the batch."""
    dev = torch.device(device)

    def loss_fn(model, batch):
        cpad, valid, feats, labels = (torch.as_tensor(a, device=dev)
                                      for a in batch)
        st = sparse_tensor(cpad, feats, capacity=cfg.capacity,
                           batch_size=cfg.batch_per_device, valid=valid,
                           extent=(cfg.resolution,) * 3)
        return F.cross_entropy(model(st), labels.long()), {}

    return loss_fn


def replica_digest(module: torch.nn.Module) -> str:
    """SHA-1 of every parameter's and buffer's bytes, in order."""
    h = hashlib.sha1()
    for t in list(module.parameters()) + list(module.buffers()):
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy())
    return h.hexdigest()


def replica_digests(module: torch.nn.Module, group=None) -> List[str]:
    """Every rank's ``replica_digest`` of ``module``, in rank order."""
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, replica_digest(module), group=group)
    return every


def check_replicas(module: torch.nn.Module, group=None) -> str:
    """Raise unless every rank of ``group`` holds the same parameters and
    buffers, bit for bit; returns the digest."""
    every = replica_digests(module, group)
    if len(set(every)) != 1:
        raise RuntimeError(f"the ranks' parameters differ: {every}")
    return every[0]


def train(cfg, group=None, device=None) -> dict:
    """One rank's run inside an initialised process group: returns its
    per-step losses, wall seconds and collective payloads, and the
    replicas' digest."""
    dev = resolve_device(device)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    ds = SyntheticShapes(resolution=cfg.resolution, num_samples=256,
                         points_per_shape=512)
    net = ResNet14(out_channels=4, input_capacity=cfg.capacity,
                   process_group=group, device=dev, seed=cfg.seed)
    broadcast_module(net, group)
    state = TrainState(net, vae_optimizer(net.parameters(), cfg.lr))
    ckpt = CheckpointManager(cfg.ckpt_dir) if cfg.ckpt_dir else None
    if ckpt is not None:
        state = ckpt.restore(state)
        if rank == 0:
            log.info("resumed at step %d", state.step)
    step_fn = make_dp_train_step(build_loss_fn(cfg, dev), group)
    out = {"loss": [], "wall_s": [], "comm": []}
    while state.step < cfg.steps:
        batch = rank_batch(ds, cfg, state.step, rank, world)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss, _ = step_fn(state, batch)
        loss = float(loss)
        wall = time.perf_counter() - t0
        out["loss"].append(loss)
        out["wall_s"].append(wall)
        out["comm"].append(dict(step_fn.comm))
        if not np.isfinite(loss):
            raise FloatingPointError(f"step {state.step}: loss {loss}")
        if rank == 0:
            log.info("step %d loss %.4f  %.3fs  (%d devices, global batch "
                     "%d)", state.step - 1, loss, wall, world,
                     world * cfg.batch_per_device)
        if ckpt is not None and (state.step % cfg.save_every == 0 or
                                 state.step == cfg.steps):
            if rank == 0:
                ckpt.save(state.step, state)
            dist.barrier(group)
    out["digest"] = check_replicas(net, group)
    if rank == 0:
        log.info("done (%d ranks agree: %s)", world, out["digest"][:12])
    return out


def _spawned(rank: int, cfg, port: int) -> None:
    logging.basicConfig(level=logging.INFO)
    dev = rank_device(cfg.device or "cuda", rank, cfg.nproc)
    initialize_distributed(f"127.0.0.1:{port}", cfg.nproc, rank,
                           backend=cfg.backend)
    try:
        train(cfg, device=dev)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    cfg = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
        local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        dev = rank_device(cfg.device or "cuda",
                          int(os.environ.get("LOCAL_RANK", 0)), local)
        check_backend(cfg.backend, dev, local)
        initialize_distributed(backend=cfg.backend)
        try:
            train(cfg, device=dev)
        finally:
            dist.destroy_process_group()
        return 0
    check_backend(cfg.backend, cfg.device or "cuda", cfg.nproc)
    torch.multiprocessing.start_processes(
        _spawned, args=(cfg, free_port()), nprocs=cfg.nproc, join=True,
        start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
