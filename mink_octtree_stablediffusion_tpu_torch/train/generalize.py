"""Training on a procedural shape distribution with the latent canvas: the
counterpart of phases 1 and 2 of `scripts/e2e_generalize.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.generalize \\
        --stream --steps_vae 6000 --steps_diff 15000
    python -m mink_octtree_stablediffusion_tpu_torch.train.generalize \\
        --device cpu --resolution 32 --points 512 --input_capacity 1024 \\
        --train_shapes 8 --val_shapes 4 --batch_size 2 \\
        --vae_channel 4 8 8 8 4 --unet_channel 4 8 8 8 --group 4 \\
        --steps_vae 2 --steps_diff 2 --ckpt_dir ckpt_generalize_tiny

Same flags and defaults as the script (resolution 64, batch 4, 32,768
points a shape, 65,536 input rows, 512 train and 32 val `ProceduralShapes`
with ``composite_prob`` 0.25, VAE (32, 128, 512, 512, 4), UNet (4, 128,
256, 384) with group 32, seed 0), plus ``--device`` (default: the card).

- Phase 1 trains the VAE with ``latent_canvas`` (the decoder's level 0
  holds ``batch·cells`` rows, ``cells = (resolution/8)³``; the empty
  canvas cells get N(0, ``canvas_noise``²) in training) on batches from
  the train pool (or, with ``--stream``, fresh shapes made by host
  threads), with clipping at 1.0 and Adam on a 20-step warmup-cosine
  schedule (``optim.canvas_vae_optimizer``), and reports the held-out
  reconstruction IoU (``val_recon_iou``) every ``--eval_every`` steps and
  at the end, on the val split and on as many train shapes.
- Phase 2 trains diffusion on the frozen VAE's canvas latents
  (``encode_canvas``) with a UNet sized by the canvas
  (``canvas_unet``: ``attn_window``, ``remat``, ``level0_skip``), AdamW
  or Adafactor (``--diff_opt``) on a 100-step warmup, and the
  ``sample`` / ``v_prediction`` / ``epsilon`` target without the NLL.

- Phase 3 generates template-free: ``--gen_samples`` samples (rounds of
  one batch, seeds ``seed + 100 + i``) denoised from N(0,1) on the
  data-independent canvas (``ops.canvas_grid``, a zero template) over
  ``--sample_steps`` DDPM steps and decoded by the pruning decoder, then
  scored against the train and val shapes by ``generation_metrics``:
  each sample's nearest-train and nearest-val voxel IoU (novelty: low
  means not a copy), the novelty histogram, and the share of samples
  whose voxel count lies within 0.3x-3x the train median
  (``gen_size_valid_frac``).  ``--viz_dir`` renders a held-out shape,
  its reconstruction and one batch of samples to
  ``e2e_generalize[_<tag>].png``.

Checkpoints go to ``<ckpt_dir>/vae`` and ``<ckpt_dir>/diff_<prediction>``
every 2000 steps and at the end; a run resumes each phase from its
latest, and ``--skip_vae`` / ``--skip_diff`` restore a phase instead of
training it.

``--stream_device`` synthesizes every training batch on the device
(`data.procedural_batch`, the script's ``procedural_batch`` stream): one
``torch.Generator`` seeded with ``seed + 77``, which each batch advances,
where the script folds a batch counter into ``PRNGKey(seed + 77)``.  The
shapes follow the same distribution, not the same draws.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import ProceduralShapes, collate_pointclouds, procedural_batch
from ..diffusion import (DDPMScheduler, diffusion_training_loss,
                         sample_latent)
from ..models.unet import UNet
from ..models.vae import VAE
from ..ops.canvas import canvas_grid, expand_to_canvas
from ..serve import capacities
from ..tensor import SparseTensor, sparse_tensor
from ..utils.device import make_generator, resolve_device
from .optim import (adafactor_diffusion_optimizer, canvas_vae_optimizer,
                    diffusion_optimizer)
from .trainer import CheckpointManager, TrainState, make_train_step
from .vae import build_loss_fn as build_vae_loss_fn

log = logging.getLogger("train_generalize")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--points", type=int, default=32768)
    p.add_argument("--input_capacity", type=int, default=65536)
    p.add_argument("--train_shapes", type=int, default=512)
    p.add_argument("--val_shapes", type=int, default=32)
    p.add_argument("--stream", action="store_true",
                   help="fresh shapes for every train batch, made by host "
                        "threads")
    p.add_argument("--stream_workers", type=int, default=3)
    p.add_argument("--stream_device", action="store_true",
                   help="synthesize the training batches on the device")
    p.add_argument("--caps", type=int, nargs=9, default=None,
                   help="5 encoder + 4 decoder capacities")
    p.add_argument("--composite_prob", type=float, default=0.25)
    p.add_argument("--vae_channel", type=int, nargs=5,
                   default=[32, 128, 512, 512, 4])
    p.add_argument("--unet_channel", type=int, nargs=4,
                   default=[4, 128, 256, 384])
    p.add_argument("--steps_vae", type=int, default=6000)
    p.add_argument("--steps_diff", type=int, default=15000)
    p.add_argument("--vae_scale", type=float, default=0.1428)
    p.add_argument("--canvas_noise", type=float, default=1.0)
    p.add_argument("--lr_vae", type=float, default=1e-3)
    p.add_argument("--lr_diff", type=float, default=2e-4)
    p.add_argument("--group", type=int, default=32)
    p.add_argument("--kld_weight", type=float, default=1e-6)
    p.add_argument("--prediction_type",
                   choices=["epsilon", "sample", "v_prediction"],
                   default="sample")
    p.add_argument("--diff_opt", choices=["adamw", "adafactor"],
                   default="adamw")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--attn_window", type=int, default=None)
    p.add_argument("--attn_max_len", type=int, default=None)
    p.add_argument("--level0_skip", action="store_true")
    p.add_argument("--eval_every", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt_dir", type=str, default="ckpt_generalize")
    p.add_argument("--skip_vae", action="store_true")
    p.add_argument("--skip_diff", action="store_true")
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--gen_samples", type=int, default=16)
    p.add_argument("--tag", type=str, default="",
                   help="suffix of the render's file name")
    p.add_argument("--viz_dir", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def canvas_cells(resolution: int) -> int:
    """Canvas cells per instance at the stride-8 latent."""
    return (-(-resolution // 8)) ** 3


def canvas_vae(*, vae_channel: Sequence[int], input_capacity: int,
               batch_size: int, resolution: int,
               caps: Optional[Sequence[int]] = None,
               canvas_noise: float = 1.0, device=None, seed: int = 0) -> VAE:
    """The script's VAE: the `capacities()` schedule (or ``caps``, 5
    encoder + 4 decoder), the decoder's level 0 widened to hold every
    canvas cell of the batch, ``latent_canvas`` with ``canvas_noise``."""
    if caps is not None:
        enc_caps, dec_caps = tuple(caps[:5]), tuple(caps[5:])
    else:
        enc_caps, dec_caps = capacities(input_capacity)
    dec_caps = (max(dec_caps[0], batch_size * canvas_cells(resolution)),) \
        + tuple(dec_caps[1:])
    return VAE(channels=tuple(vae_channel), encoder_capacities=enc_caps,
               decoder_capacities=dec_caps, latent_canvas=True,
               canvas_noise_std=canvas_noise, device=device, seed=seed)


def canvas_unet(*, unet_channel: Sequence[int], batch_size: int,
                resolution: int, group: int = 32,
                attn_max_len: Optional[int] = None,
                attn_window: Optional[int] = None, remat: bool = False,
                level0_skip: bool = False, with_cross_attn: bool = False,
                cross_attention_dim: int = 768,
                time_embedding_norm: str = "default",
                cond_into_time: bool = False, device=None,
                seed: int = 0) -> UNet:
    """The scripts' UNet on the canvas: down capacities ``batch·cells`` /
    8, 64 and 512 and ``attn_max_len`` one canvas (rounded up to 128)
    unless given."""
    cells = canvas_cells(resolution)
    b = batch_size
    return UNet(channels=tuple(unet_channel), group=group,
                attn_max_len=attn_max_len or max(-(-cells // 128) * 128, 128),
                attn_window=attn_window, remat=remat,
                level0_skip=level0_skip, with_cross_attn=with_cross_attn,
                cross_attention_dim=cross_attention_dim,
                time_embedding_norm=time_embedding_norm,
                cond_into_time=cond_into_time,
                down_capacities=(max(b * cells // 8, 16),
                                 max(b * cells // 64, 8),
                                 max(b * cells // 512, 8)),
                device=device, seed=seed)


def build_input(batch, *, input_capacity: int, batch_size: int,
                resolution: int, device):
    """A collated ``(cpad, valid, feats, ...)`` (numpy or tensors) → the
    input SparseTensor on ``device``."""
    cpad, valid, feats = (torch.as_tensor(a, device=device)
                          for a in batch[:3])
    return sparse_tensor(cpad, feats, capacity=input_capacity,
                         batch_size=batch_size, valid=valid,
                         extent=(resolution,) * 3)


@torch.no_grad()
def encode_canvas(vae: VAE, st, vae_scale: float):
    """The frozen VAE's mean (eval mode, no graph) scaled by
    ``vae_scale`` and scattered onto the full canvas (zeros at the empty
    cells)."""
    vae.eval()
    mean, _ = vae.encode(st)
    mean = mean.with_features(mean.features * vae_scale)
    canvas = canvas_grid(st.batch_size, mean.grid.extent, mean.grid.stride,
                         mean.grid.ndim, device=mean.features.device)
    return expand_to_canvas(mean, canvas)


def build_diffusion_loss_fn(vae: VAE, scheduler, *, input_capacity: int,
                            batch_size: int, resolution: int,
                            vae_scale: float, prediction_type: str,
                            device, cond_table: Optional[torch.Tensor] = None,
                            cond_dropout: float = 0.0):
    """``loss_fn(model, batch, generator=None, timesteps=None, noise=None,
    drop=None) -> (loss, aux)``: the diffusion loss on the frozen VAE's
    canvas latent, without the coordinate NLL; ``model`` is a
    ``ModuleDict`` holding the ``unet``.

    Conditioned (`scripts/cond_control.py`), ``batch`` also holds the
    class labels: the condition is ``table[labels]``, the table being the
    model's learned ``cond_table`` parameter where it has one, else the
    frozen ``cond_table`` given here, and each instance's condition is
    zeroed with probability ``cond_dropout`` (classifier-free guidance):
    ``drop`` (bool [B]) where given, else a draw from ``generator``."""
    dev = torch.device(device)

    def loss_fn(model, batch, generator=None, timesteps=None, noise=None,
                drop=None):
        st = build_input(batch, input_capacity=input_capacity,
                         batch_size=batch_size, resolution=resolution,
                         device=dev)
        latent = encode_canvas(vae, st, vae_scale)
        ehs = None
        table = getattr(model, "cond_table", cond_table)
        if table is not None:
            labels = torch.as_tensor(batch[3], device=dev).long()
            if drop is None:
                drop = torch.rand((batch_size,), generator=generator,
                                  device=dev) < cond_dropout
            ehs = torch.where(torch.as_tensor(drop, device=dev)[:, None,
                                                                None],
                              0.0, table[labels])
        return diffusion_training_loss(
            model["unet"], scheduler, latent, resolution=resolution,
            prediction_type=prediction_type, encoder_hidden_state=ehs,
            timesteps=timesteps, noise=noise, generator=generator)

    return loss_fn


def voxel_sets(st) -> dict:
    """{batch index: set of voxel coordinate tuples} of a tensor's valid
    rows."""
    c = st.grid.coords.cpu().numpy()
    v = st.grid.valid.cpu().numpy()
    out: dict = {}
    for row, ok in zip(c, v):
        if ok:
            out.setdefault(int(row[0]), set()).add(
                tuple(int(x) for x in row[1:]))
    return out


def iou_sets(a: set, b: set) -> float:
    u = len(a | b)
    return len(a & b) / u if u else 1.0


def mean_iou(sets_a: dict, sets_b: dict) -> float:
    vals = [iou_sets(sets_a[k], sets_b.get(k, set())) for k in sets_a]
    return float(np.mean(vals)) if vals else 0.0


def flat_keys(coords, resolution: int) -> np.ndarray:
    """Sorted unique int64 flat keys ``(x·res + y)·res + z`` of [N, 3]
    voxels: the banks' membership tests run on sorted key intersections,
    not on Python sets of tuples (at resolution 128 a 4,096-shape bank of
    tuple sets takes tens of GB)."""
    c = np.asarray(coords, np.int64).reshape(-1, 3)
    return np.unique((c[:, 0] * resolution + c[:, 1]) * resolution + c[:, 2])


def iou_keys(a: np.ndarray, b: np.ndarray) -> float:
    """Voxel IoU of two ``flat_keys`` arrays (1 for two empty sets)."""
    inter = len(np.intersect1d(a, b, assume_unique=True))
    u = len(a) + len(b) - inter
    return inter / u if u else 1.0


def generation_metrics(gen_sets, train_coords, val_coords,
                       resolution: int) -> dict:
    """`scripts/e2e_generalize.py`'s membership and novelty metrics of the
    generated voxel sets (``gen_sets``: one set of (x, y, z) tuples a
    sample) against the train and val shapes ([N, 3] arrays): each
    sample's nearest-train and nearest-val IoU, the novelty histogram of
    the nearest-train IoU (bins of 0.1 over [0, 1]), the voxel counts, and
    the share of samples whose count lies within [0.3, 3] x the train
    shapes' median count (the size validity; nearest IoU is a novelty
    metric, not a validity gate)."""
    train_bank = [flat_keys(c, resolution) for c in train_coords]
    val_bank = [flat_keys(c, resolution) for c in val_coords]
    gen_keys = [flat_keys(sorted(g), resolution) if g else
                np.empty((0,), np.int64) for g in gen_sets]
    counts = [len(g) for g in gen_sets]
    median = float(np.median([len(t) for t in train_bank]))
    nearest_train = [max((iou_keys(g, t) for t in train_bank), default=0.0)
                     for g in gen_keys]
    nearest_val = [max((iou_keys(g, t) for t in val_bank), default=0.0)
                   for g in gen_keys]
    hist, edges = np.histogram(nearest_train, bins=np.arange(0, 1.05, 0.1))
    return {"counts": counts, "nearest_train": nearest_train,
            "nearest_val": nearest_val,
            "novelty_histogram": dict(zip([f"{e:.1f}" for e in edges[:-1]],
                                          hist.tolist())),
            "gen_size_valid_frac": float(np.mean(
                [0.3 * median <= c <= 3.0 * median for c in counts])),
            "gen_nearest_train_iou_mean": float(np.mean(nearest_train)),
            "gen_nearest_train_iou_max": float(np.max(nearest_train)),
            "gen_nearest_val_iou_mean": float(np.mean(nearest_val)),
            "gen_voxels_median": int(np.median(counts))}


@torch.no_grad()
def generate_canvas(vae: VAE, unet: UNet, scheduler, target_grid, *,
                    batch_size: int, resolution: int, latent_channels: int,
                    vae_scale: float, sample_steps: int, seed: int):
    """One batch of template-free samples (`scripts/e2e_generalize.py`
    phase 3): N(0,1) features from ``seed`` on the stride-8 canvas,
    ``sample_steps`` steps of ``scheduler`` with the UNet, then the
    pruning decoder (eval mode; ``target_grid`` is only a structural
    argument there: any grid of the batch)."""
    vae.eval()
    unet.eval()
    dev = target_grid.coords.device
    canvas = canvas_grid(batch_size, (resolution,) * 3, (8,) * 3,
                         device=dev)
    template = SparseTensor(grid=canvas, features=torch.zeros(
        (canvas.capacity, latent_channels), device=dev))
    z = sample_latent(unet, scheduler, template,
                      num_inference_steps=sample_steps,
                      generator=make_generator(seed, dev))
    _, _, sout = vae.decode(z.with_features(z.features / vae_scale),
                            target_grid)
    return sout


@torch.no_grad()
def reconstruct(vae: VAE, batch, *, input_capacity: int, batch_size: int,
                resolution: int, device, seed: int = 9):
    """(input, decoded) tensors of one batch through the VAE in eval mode
    (running statistics, no canvas noise, the reparameterisation noise
    from ``seed``)."""
    st = build_input(batch, input_capacity=input_capacity,
                     batch_size=batch_size, resolution=resolution,
                     device=device)
    was = vae.training
    vae.eval()
    _, _, sout, _, _, _ = vae(st, st.grid,
                              generator=make_generator(seed, st.C.device))
    vae.train(was)
    return st, sout


def val_recon_iou(vae: VAE, batches, **kw) -> float:
    """Mean over ``batches`` of the per-instance voxel-set IoU between
    the input and its reconstruction."""
    vals = []
    for b in batches:
        st_in, st_rec = reconstruct(vae, b, **kw)
        vals.append(mean_iou(voxel_sets(st_in), voxel_sets(st_rec)))
    return float(np.mean(vals))


def shape_stream(ds, batch_size: int, capacity: int, workers: int):
    """``next_batch()`` of fresh shapes (indices 0, 1, 2, … of ``ds``),
    collated by ``workers`` host threads ahead of the steps."""
    counter = itertools.count()
    pool = ThreadPoolExecutor(max_workers=workers)

    def make():
        return collate([ds[next(counter)] for _ in range(batch_size)],
                       capacity)

    queue = deque(pool.submit(make) for _ in range(2 * workers))

    def next_batch():
        fut = queue.popleft()
        queue.append(pool.submit(make))
        return fut.result()

    return next_batch


def collate(samples, capacity: int):
    """``samples`` → ``(cpad, valid, feats, labels)`` through
    `collate_pointclouds`, which drops the largest shapes while the batch
    overflows ``capacity``: batch instance i holds the i-th kept sample,
    so the labels follow the kept samples, and the instances left empty
    carry the dropped samples' labels.  (`scripts/cond_control.py` keeps
    its labels in sample order, which misaligns them once a shape is
    dropped.)"""
    cpad, valid, feats, kept = collate_pointclouds(
        [s["coords"] for s in samples], capacity)
    order = list(kept) + [i for i in range(len(samples)) if i not in kept]
    return cpad, valid, feats, np.asarray([samples[i]["label"]
                                           for i in order])


def run_steps(name: str, state: TrainState, step_fn, next_batch, gen,
              steps: int, ckpt: CheckpointManager, log_every: int,
              on_step=None) -> Optional[float]:
    """Steps ``state`` to ``steps`` (resuming from its step), logging every
    ``log_every`` steps and at the end, checkpointing every 2000 steps and
    at the end; returns the last loss."""
    t0, step0, loss = time.time(), state.step, None
    while state.step < steps:
        loss, aux = step_fn(state, next_batch(), gen)
        step = state.step
        if step % log_every == 0 or step == steps:
            extra = " ".join(f"{k} {float(v):.5f}" for k, v in aux.items())
            log.info("%s step %d loss %.5f %s (%.2f s/step)", name, step,
                     float(loss), extra, (time.time() - t0) / (step - step0))
        if on_step is not None:
            on_step(step)
        if step % 2000 == 0:
            ckpt.save(step, state)
    if ckpt.latest_step() != state.step:
        ckpt.save(state.step, state)
    return None if loss is None else float(loss)


def main(argv=None) -> dict:
    cfg = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    res, b, cap = cfg.resolution, cfg.batch_size, cfg.input_capacity
    if res % 8:
        raise ValueError("the resolution must be a multiple of 8")
    dev = resolve_device(cfg.device)
    shapes = dict(resolution=res, points_per_shape=cfg.points,
                  seed=cfg.seed, composite_prob=cfg.composite_prob)
    train_ds = ProceduralShapes(num_samples=cfg.train_shapes, split="train",
                                **shapes)
    val_ds = ProceduralShapes(num_samples=cfg.val_shapes, split="val",
                              **shapes)
    t0 = time.time()
    train_pool = [train_ds[i] for i in range(cfg.train_shapes)]
    val_pool = [val_ds[i] for i in range(cfg.val_shapes)]
    log.info("%d train / %d val shapes in %.1f s; train voxels a shape %.0f",
             cfg.train_shapes, cfg.val_shapes, time.time() - t0,
             np.mean([len(s["coords"]) for s in train_pool]))
    np_rng = np.random.RandomState(cfg.seed + 1)
    if cfg.stream_device:
        stream_gen = make_generator(cfg.seed + 77, dev)

        def train_batch():
            return procedural_batch(stream_gen, b, cfg.points, res, cap,
                                    composite_prob=cfg.composite_prob)
    elif cfg.stream:
        train_batch = shape_stream(train_ds, b, cap, cfg.stream_workers)
    else:
        def train_batch():
            return collate([train_pool[i] for i in
                            np_rng.randint(0, cfg.train_shapes, b)], cap)
    val_batches = [collate(val_pool[i:i + b], cap)
                   for i in range(0, cfg.val_shapes - b + 1, b)]
    n_probe = min(cfg.train_shapes, cfg.val_shapes)
    train_probe = [collate(train_pool[i:i + b], cap)
                   for i in range(0, n_probe - b + 1, b)]
    sizes = dict(input_capacity=cap, batch_size=b, resolution=res)

    # phase 1: the canvas VAE on the training distribution
    vae = canvas_vae(vae_channel=cfg.vae_channel, caps=cfg.caps,
                     canvas_noise=cfg.canvas_noise, device=dev,
                     seed=cfg.seed, **sizes)
    log.info("vae params: %d", sum(p.numel() for p in vae.parameters()))
    state = TrainState(vae, canvas_vae_optimizer(
        vae.parameters(), cfg.lr_vae, cfg.steps_vae))
    vae_ckpt = CheckpointManager(os.path.join(cfg.ckpt_dir, "vae"))
    state = vae_ckpt.restore(state)
    gen = make_generator(cfg.seed, dev)
    if cfg.skip_vae:
        log.info("restored VAE at step %d", state.step)
    else:
        log.info("VAE from step %d", state.step)
        step_fn = make_train_step(build_vae_loss_fn(
            kld_weight=cfg.kld_weight, device=dev, **sizes))

        def evaluate(step):
            if step % cfg.eval_every == 0:
                log.info("  val recon IoU @ %d: %.4f", step, val_recon_iou(
                    vae, val_batches[:2], device=dev, **sizes))
        run_steps("vae", state, step_fn, lambda: train_batch()[:3], gen,
                  cfg.steps_vae, vae_ckpt, 100, evaluate)
    vae.requires_grad_(False)
    result = {"val_recon_iou": val_recon_iou(vae, val_batches, device=dev,
                                             **sizes),
              "train_recon_iou": val_recon_iou(vae, train_probe,
                                               device=dev, **sizes),
              "train_shapes": cfg.train_shapes,
              "stream": bool(cfg.stream or cfg.stream_device),
              "stream_device": cfg.stream_device,
              "resolution": res, "steps_vae": state.step}
    log.info("held-out reconstruction IoU (%d val shapes): %.4f (train "
             "%.4f)", cfg.val_shapes, result["val_recon_iou"],
             result["train_recon_iou"])
    if cfg.steps_diff == 0:
        print(json.dumps(result), flush=True)
        return result

    # phase 2: diffusion on the frozen VAE's canvas latents
    unet = canvas_unet(unet_channel=cfg.unet_channel, batch_size=b,
                       resolution=res, group=cfg.group,
                       attn_max_len=cfg.attn_max_len,
                       attn_window=cfg.attn_window, remat=cfg.remat,
                       level0_skip=cfg.level0_skip, device=dev,
                       seed=cfg.seed + 1)
    log.info("unet params: %d", sum(p.numel() for p in unet.parameters()))
    model = torch.nn.ModuleDict({"unet": unet})
    make_opt = (adafactor_diffusion_optimizer if cfg.diff_opt == "adafactor"
                else diffusion_optimizer)
    dstate = TrainState(model, make_opt(model.parameters(), cfg.lr_diff,
                                        warmup_steps=100,
                                        total_steps=cfg.steps_diff))
    diff_ckpt = CheckpointManager(
        os.path.join(cfg.ckpt_dir, f"diff_{cfg.prediction_type}"))
    dstate = diff_ckpt.restore(dstate)
    if cfg.skip_diff:
        log.info("restored diffusion at step %d", dstate.step)
    else:
        log.info("diffusion from step %d", dstate.step)
        sched = DDPMScheduler.create(prediction_type=cfg.prediction_type)
        dstep_fn = make_train_step(build_diffusion_loss_fn(
            vae, sched, vae_scale=cfg.vae_scale,
            prediction_type=cfg.prediction_type, device=dev, **sizes))
        result["diff_loss_last"] = run_steps(
            "diff", dstate, dstep_fn, train_batch, gen, cfg.steps_diff,
            diff_ckpt, 200)
    result["steps_diff"] = dstate.step

    # phase 3: template-free generation, membership and novelty
    sched = DDPMScheduler.create(prediction_type=cfg.prediction_type)
    tgt = build_input(val_batches[0], device=dev, **sizes).grid

    def generate(i):
        return generate_canvas(vae, unet, sched, tgt, batch_size=b,
                               resolution=res,
                               latent_channels=cfg.vae_channel[-1],
                               vae_scale=cfg.vae_scale,
                               sample_steps=cfg.sample_steps,
                               seed=cfg.seed + 100 + i)
    gen_sets = []
    for i in range(max(cfg.gen_samples // b, 1)):
        sets = voxel_sets(generate(i))
        gen_sets.extend(sets.get(j, set()) for j in range(b))
    m = generation_metrics(gen_sets, [s["coords"] for s in train_pool],
                           [s["coords"] for s in val_pool], res)
    log.info("generated %d samples; voxels/sample min %d median %d max %d",
             len(gen_sets), min(m["counts"]), m["gen_voxels_median"],
             max(m["counts"]))
    log.info("nearest-train IoU per sample: %s",
             [round(v, 3) for v in m["nearest_train"]])
    log.info("nearest-val IoU per sample: %s",
             [round(v, 3) for v in m["nearest_val"]])
    log.info("novelty histogram (nearest-train IoU): %s",
             m["novelty_histogram"])
    if cfg.viz_dir:
        from ..utils.viz import render_pointclouds, sparse_tensor_clouds

        st_v, st_vrec = reconstruct(vae, val_batches[0], device=dev,
                                    **sizes)
        tag = f"_{cfg.tag}" if cfg.tag else ""
        path = render_pointclouds(
            [sparse_tensor_clouds(st_v, 1)[0],
             sparse_tensor_clouds(st_vrec, 1)[0]] +
            sparse_tensor_clouds(generate(0), b),
            os.path.join(cfg.viz_dir, f"e2e_generalize{tag}.png"),
            titles=["held-out data", "held-out recon"] +
                   [f"generated {i}" for i in range(b)],
            resolution=res)
        log.info("render: %s", path)
    result.update({k: m[k] for k in (
        "gen_size_valid_frac", "gen_nearest_train_iou_mean",
        "gen_nearest_train_iou_max", "gen_nearest_val_iou_mean",
        "gen_voxels_median")},
        prediction_type=cfg.prediction_type, stream_device=cfg.stream_device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
