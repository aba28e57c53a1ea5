"""A data-parallel dry run on N ranks: the port of
`__graft_entry__.py::dryrun_multichip`.

    python -m mink_octtree_stablediffusion_tpu_torch.parallel.dryrun \\
        --world_size 2 --backend gloo --device cpu

``dryrun_multichip(world_size, backend, device)`` spawns ``world_size``
ranks and runs JAX's phases at JAX's tiny sizes:

1. one data-parallel diffusion step: UNet (4, 8, 16, 16) on a random
   stride-8 latent per rank, DDPM with 100 steps, AdamW at 1e-4, the
   coordinate NLL; finite, the parameters moved;
2. with ``world_size >= 4`` and even, one dp × tp step on the ``(2,
   world_size // 2)`` mesh (``tp_phase``): the same UNet with its conv
   and dense kernels sharded on Cout over the model axis, a random latent
   per data row, SGD at 1e-3; finite, and the conv kernels keep their
   local Cout slices;
3. one data-parallel step of the full VAE with SyncBN (growth,
   membership, top-k, pruning, the dense canvas latent): VAE (4, 8, 8, 8,
   2) at resolution 16 on a different random batch per rank, Adam at
   1e-3; finite, moved;
4. data-parallel sampling: each rank runs DDIM (4 steps) from its own
   generator on the canvas with UNet (2, 8, 16, 16) (Morton-window
   attention, ``level0_skip``) and phase 3's VAE decodes against its
   rank's grid; rank 0 gathers the shards through the host.  Every shard
   is finite with > 0 voxels, the shards differ, and each equals the
   sample a single process draws with that rank's generator.

Each rank's generator is ``train.split_device_rngs``'s (phase 2: each
data row's).  Returns rank 0's record; raises if a check fails.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .. import diffusion as md
from ..models import UNet, VAE, vae_loss
from ..ops.canvas import canvas_grid
from ..ops.coords import batched_coordinates_np, pad_to_capacity
from ..tensor import SparseTensor, sparse_tensor
from ..train import (TrainState, broadcast_module, make_dp_train_step,
                     split_device_rngs, vae_optimizer)
from .mesh import (check_backend, data_parallel_mesh, free_port,
                   gather_to_host, initialize_distributed, rank_device)
from .tp import dp_tp_mesh, shard_model_params

B, CAP, C, STRIDE, RES = 2, 64, 4, 8, 4  # phase 1's latent batch
VRES, VCAP, VB = 16, 256, 2  # phase 3's VAE batch


def latent_batch(rng: np.random.RandomState, b=B, cap=CAP, c=C,
                 stride=STRIDE, res=RES):
    """`__graft_entry__._latent_batch`: b random stride-``stride`` voxel
    sets with N(0, 1) features."""
    vox = [np.unique(rng.randint(0, res, (cap // (2 * b), 3)), axis=0) *
           stride for _ in range(b)]
    cpad, vpad = pad_to_capacity(batched_coordinates_np(vox), cap)
    feats = rng.randn(cap, c).astype(np.float32) * vpad[:, None]
    return cpad, vpad, feats


def vae_batch(seed: int):
    """Phase 3's batch of rank ``seed``: VB random voxel sets at VRES."""
    r = np.random.RandomState(seed)
    vox = [np.unique(r.randint(0, VRES, (VCAP // (2 * VB), 3)), axis=0)
           for _ in range(VB)]
    cpad, vpad = pad_to_capacity(batched_coordinates_np(vox), VCAP)
    return cpad, vpad, np.ones((VCAP, 1), np.float32) * vpad[:, None]


def _moved(after: dict, before: dict) -> float:
    return float(sum((after[n] - before[n]).abs().sum() for n in before))


def _params(module) -> dict:
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def phase1_unet(dev, seed: int = 0) -> UNet:
    return UNet(channels=(4, 8, 16, 16), attn_max_len=32,
                down_capacities=(32, 16, 8), group=4, device=dev, seed=seed)


def tp_phase(mesh, device, seed: int = 0) -> dict:
    """Phase 2 on ``mesh`` (``dp_tp_mesh``), every rank calling it: one
    dp × tp step of phase 1's UNet (seeded alike on every rank) with its
    kernels sharded on the model axis, on a random latent per data row
    with that row's draws, the coordinate NLL at its initial (μ, Σ), as
    JAX's phase 2, and SGD at 1e-3; → ``tp_loss``, ``tp_sharded`` (the
    conv kernels sharded) and ``tp_kept`` (those that still hold their
    local Cout slice after the step)."""
    dev = torch.device(device)
    data = mesh.get_group("data")
    row = mesh.get_local_rank("data")
    gen = split_device_rngs(seed + 2, mesh["data"].size(), dev)[row]
    unet = shard_model_params(phase1_unet(dev, seed), mesh)
    convs = [(m.kernel, m.out_channels) for m in unet.modules()
             if getattr(m, "tp_weight", None) == "kernel" and
             m.model_shard is not None]
    sched = md.DDPMScheduler.create(num_train_timesteps=100)
    nll = md.CoordNLLParams(device=dev)

    def loss_fn(unet, batch):
        cpad, vpad, feats = (torch.as_tensor(a, device=dev) for a in batch)
        lat = sparse_tensor(cpad, feats, capacity=CAP, batch_size=B,
                            stride=STRIDE, valid=vpad,
                            extent=(RES * STRIDE,) * 3)
        return md.diffusion_training_loss(
            unet, sched, lat, nll_params=nll, resolution=RES * STRIDE,
            generator=gen)

    state = TrainState(unet, torch.optim.SGD(unet.parameters(), 1e-3))
    loss, _ = make_dp_train_step(loss_fn, data)(
        state, latent_batch(np.random.RandomState(row)))
    n = mesh["model"].size()
    return {"tp_loss": float(loss), "tp_sharded": len(convs),
            "tp_kept": sum(k.shape[2] * n == c for k, c in convs)}


def run_rank(world: int, device, seed: int = 0) -> dict:
    """One rank's phases 1, 3 and 4 inside an initialised process group."""
    dev = torch.device(device)
    group = data_parallel_mesh(world)
    rank = dist.get_rank(group)
    gen = split_device_rngs(seed, world, dev)[rank]
    rec = {}

    # phase 1: a data-parallel diffusion step
    unet = phase1_unet(dev, seed)
    model = torch.nn.ModuleDict({"unet": unet,
                                 "nll": md.CoordNLLParams(device=dev)})
    broadcast_module(model, group)
    sched = md.DDPMScheduler.create(num_train_timesteps=100)

    def diff_loss(model, batch):
        cpad, vpad, feats = (torch.as_tensor(a, device=dev) for a in batch)
        lat = sparse_tensor(cpad, feats, capacity=CAP, batch_size=B,
                            stride=STRIDE, valid=vpad,
                            extent=(RES * STRIDE,) * 3)
        return md.diffusion_training_loss(
            model["unet"], sched, lat, nll_params=model["nll"],
            resolution=RES * STRIDE, generator=gen)

    before = _params(model)
    state = TrainState(model, torch.optim.AdamW(
        model.parameters(), 1e-4, eps=1e-8, weight_decay=1e-4))
    loss, _ = make_dp_train_step(diff_loss, group)(
        state, latent_batch(np.random.RandomState(rank)))
    rec["diffusion_loss"] = float(loss)
    rec["diffusion_moved"] = _moved(_params(model), before)

    # phase 2: dp x tp on a (2, world // 2) mesh
    if world >= 4 and world % 2 == 0:
        rec.update(tp_phase(dp_tp_mesh(2, world // 2, dev.type), dev, seed))

    # phase 3: the full VAE step with SyncBN
    cells = (VRES // 8) ** 3
    vae = VAE(channels=(4, 8, 8, 8, 2),
              encoder_capacities=(128, 64, 32, 32, 32),
              decoder_capacities=(max(VB * cells, 16), 64, 128, 256),
              latent_canvas=True, process_group=group, device=dev,
              seed=seed + 3)
    broadcast_module(vae, group)

    def vae_loss_fn(model, batch):
        cpad, vpad, feats = (torch.as_tensor(a, device=dev) for a in batch)
        st = sparse_tensor(cpad, feats, capacity=VCAP, batch_size=VB,
                           valid=vpad, extent=(VRES,) * 3)
        out_clss, targets, _, mean, log_var, _ = model(st, st.grid,
                                                       generator=gen)
        return vae_loss(out_clss, targets, mean, log_var, 1e-6)

    before = _params(vae)
    vstate = TrainState(vae, vae_optimizer(vae.parameters(), 1e-3))
    vloss, _ = make_dp_train_step(vae_loss_fn, group)(
        vstate, vae_batch(rank))
    rec["vae_loss"] = float(vloss)
    rec["vae_moved"] = _moved(_params(vae), before)

    # phase 4: sampling, one shard per rank, gathered on rank 0
    vae.eval()
    sunet = UNet(channels=(2, 8, 16, 16), attn_max_len=8, attn_window=16,
                 level0_skip=True, down_capacities=(16, 8, 8), group=4,
                 device=dev, seed=seed + 5).eval()
    broadcast_module(sunet, group)
    ddim = md.DDIMScheduler.create(num_train_timesteps=100)
    canvas = canvas_grid(VB, (VRES,) * 3, (8,) * 3, device=dev)
    template = SparseTensor(grid=canvas, features=torch.zeros(
        (canvas.capacity, 2), device=dev))

    @torch.no_grad()
    def sample(r: int, generator):
        cpad, vpad, feats = (torch.as_tensor(a, device=dev)
                             for a in vae_batch(r))
        tgt = sparse_tensor(cpad, feats, capacity=VCAP, batch_size=VB,
                            valid=vpad, extent=(VRES,) * 3).grid
        z = md.sample_latent(sunet, ddim, template, num_inference_steps=4,
                             generator=generator)
        _, _, sout = vae.decode(z, tgt)
        return torch.cat([sout.features, sout.valid[:, None].float()], 1)

    shard = sample(rank, split_device_rngs(seed + 6, world, dev)[rank])
    shards = gather_to_host(shard, group)
    if rank == 0:
        rec["kept_per_rank"] = [int(s[:, -1].sum()) for s in shards]
        rec["finite"] = bool(all(torch.isfinite(s).all() for s in shards))
        rec["shards_differ"] = world == 1 or any(
            not torch.equal(shards[0], s) for s in shards[1:])
        # each shard against the same draw in this one process
        rec["equal_single_process"] = [
            torch.equal(sample(r, split_device_rngs(seed + 6, world,
                                                    dev)[r]).cpu(), s)
            for r, s in enumerate(shards)]
    return rec


def check(rec: dict) -> None:
    """Raise unless rank 0's record shows every phase passing."""
    bad = [k for k, ok in (
        ("diffusion_loss", np.isfinite(rec["diffusion_loss"])),
        ("diffusion_moved", rec["diffusion_moved"] > 0),
        ("tp_loss", np.isfinite(rec.get("tp_loss", 0.0))),
        ("tp_kept", rec.get("tp_kept", 1) > 0),
        ("vae_loss", np.isfinite(rec["vae_loss"])),
        ("vae_moved", rec["vae_moved"] > 0),
        ("finite", rec["finite"]),
        ("kept_per_rank", min(rec["kept_per_rank"]) > 0),
        ("shards_differ", rec["shards_differ"]),
        ("equal_single_process", all(rec["equal_single_process"])))
        if not ok]
    if bad:
        raise RuntimeError(f"dryrun_multichip failed at {bad}: {rec}")


def _spawned(rank: int, world: int, backend: str, device: str, port: int,
             out: str) -> None:
    dev = rank_device(device, rank, world)
    initialize_distributed(f"127.0.0.1:{port}", world, rank,
                           backend=backend)
    try:
        rec = run_rank(world, dev)
        if rank == 0:
            torch.save(rec, out)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(world_size: int, backend: str = "gloo",
                     device: str = "cpu") -> dict:
    """Spawn ``world_size`` ranks, run the phases, check rank 0's record
    (``check``) and return it."""
    check_backend(backend, device, world_size)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        torch.multiprocessing.start_processes(
            _spawned, args=(world_size, backend, device, free_port(), out),
            nprocs=world_size, join=True, start_method="spawn")
        rec = torch.load(out, weights_only=True)
    check(rec)
    print(f"dryrun_multichip({world_size}): dp loss="
          f"{rec['diffusion_loss']:.4f} OK", flush=True)
    if "tp_loss" in rec:
        print(f"dryrun_multichip({world_size}): dp×tp loss="
              f"{rec['tp_loss']:.4f} ({rec['tp_kept']} tp-sharded kernels) "
              "OK", flush=True)
    print(f"dryrun_multichip({world_size}): VAE-dp loss="
          f"{rec['vae_loss']:.4f} (SyncBN), sampling-dp kept/rank="
          f"{rec['kept_per_rank']} OK", flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world_size", type=int, default=2)
    p.add_argument("--backend", choices=("nccl", "gloo"), required=True)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    cfg = p.parse_args(argv)
    dryrun_multichip(cfg.world_size, cfg.backend, cfg.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
