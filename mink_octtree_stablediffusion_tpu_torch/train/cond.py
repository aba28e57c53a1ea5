"""Class-conditioning control: the counterpart of `scripts/cond_control.py`
(its classifier oracle, its conditional diffusion, and its per-class
sampling and scoring).

    python -m mink_octtree_stablediffusion_tpu_torch.train.cond \\
        --ckpt_dir ckpt_generalize --cond_into_time --steps_diff 10000
    python -m mink_octtree_stablediffusion_tpu_torch.train.cond \\
        --device cpu --resolution 32 --points 512 --input_capacity 1024 \\
        --train_shapes 8 --val_shapes 2 --batch_size 2 \\
        --vae_channel 4 8 8 8 4 --unet_channel 4 8 8 8 --group 4 \\
        --cross_attention_dim 16 --steps_diff 2 --steps_cls 2 \\
        --cls_points 64 --oracle_shapes 4 --cfg_scales 3 --rounds 1 \\
        --sample_steps 2 --ckpt_dir ckpt_generalize_tiny

Same flags and defaults as the script (resolution 64, batch 4, 512 train
and 32 val `ProceduralShapes` with ``composite_prob`` 0.25, VAE (32, 128,
512, 512, 4), UNet (4, 128, 256, 384) with group 32, a [4 classes,
``cond_tokens`` 4, ``cross_attention_dim`` 256] class table from
``RandomState(7)``, learned (``--embed learned``, the default: the table
is the model's ``cond_table`` parameter) or frozen, 10% condition
dropout, AdamW at ``lr_diff`` 2e-4 on a 100-step warmup, the ``sample``
target, seed 0; full attention over one canvas), plus ``--device``
(default: the card).  In the script's order:

1. The oracle: a `MinkowskiFCNN` classifier over voxel-coordinate clouds
   (each shape's voxels subsampled to ``--cls_points``, centred, scaled
   to the unit sphere: the features; ``(x + 1) / 0.05``: the coordinates)
   trained ``--steps_cls`` steps (600) with clipping at 1.0 and Adam on a
   20-step warmup-cosine schedule at ``--lr_cls`` 1e-3; its held-out
   accuracy and row-normalised confusion matrix over ``--oracle_shapes``
   (128) val shapes, in ``.eval()``.
2. Conditional diffusion: the VAE comes from the latest
   ``train.generalize`` checkpoint under ``<ckpt_dir>/vae``, or, where
   there is none, from random weights of ``--seed``.  Each step encodes
   the batch onto the canvas (frozen VAE), conditions every instance on
   its class's table rows, zeroes each instance's condition with
   probability ``--cond_dropout`` (classifier-free guidance), and takes
   the diffusion loss through the UNet's cross-attention (and
   ``--cond_into_time``).  Checkpoints go to ``<ckpt_dir>/diff_cond``
   every 2000 steps and at the end; a run resumes there (``--skip_diff``
   restores without training).
3. For each of ``--cfg_scales`` (1, 2, 3) and each class: ``--rounds``
   (13) batches sampled from noise on the canvas (DDPM,
   ``--sample_steps`` 50, classifier-free guidance at that scale, the
   generator seeded ``seed + 997·label + 31·round + int(7919·scale)``),
   decoded by the pruning decoder, classified by the oracle: the
   conditional accuracy with its 95% Wilson half-width, the prediction
   histogram, and the true-class share after correcting for the oracle's
   confusion (least squares of ``q = Mᵀ p`` clipped to the simplex).
   ``--viz_dir`` renders one sample a class at the best scale
   (matplotlib).

The last line is the script's JSON (``classifier_val_acc``,
``classifier_val_per_class``, ``oracle_confusion``, ``oracle_shapes``,
``cfg_sweep``, ``best_scale``, ``best_mean_conditional_acc``, ``stream``)
with the diffusion phase's ``resolution``, ``embed``, ``diff_loss_last``
and ``steps_diff``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data import ProceduralShapes, collate_fields
from ..diffusion import DDPMScheduler, sample_latent
from ..models import MinkowskiFCNN
from ..ops.canvas import canvas_grid
from ..tensor import SparseTensor, TensorField
from ..utils.device import make_generator, resolve_device
from .diffusion import load_vae_checkpoint
from .generalize import (build_diffusion_loss_fn, build_input, canvas_unet,
                         canvas_vae, collate, run_steps, shape_stream,
                         voxel_sets)
from .optim import canvas_vae_optimizer, diffusion_optimizer
from .trainer import CheckpointManager, TrainState, make_train_step

log = logging.getLogger("train_generalize")
VOXEL_SIZE = 0.05  # the oracle's quantisation of unit-sphere points
CLS_EXTENT = (int(2.0 / VOXEL_SIZE) + 1,) * 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--points", type=int, default=32768)
    p.add_argument("--input_capacity", type=int, default=65536)
    p.add_argument("--train_shapes", type=int, default=512)
    p.add_argument("--val_shapes", type=int, default=32)
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
    p.add_argument("--cfg_scales", type=float, nargs="+",
                   default=[1.0, 2.0, 3.0])
    p.add_argument("--rounds", type=int, default=13)
    p.add_argument("--oracle_shapes", type=int, default=128)
    p.add_argument("--stream", action="store_true")
    p.add_argument("--steps_cls", type=int, default=600)
    p.add_argument("--cls_points", type=int, default=2048)
    p.add_argument("--steps_diff", type=int, default=10000)
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--vae_scale", type=float, default=0.1428)
    p.add_argument("--canvas_noise", type=float, default=1.0)
    p.add_argument("--lr_diff", type=float, default=2e-4)
    p.add_argument("--lr_cls", type=float, default=1e-3)
    p.add_argument("--group", type=int, default=32)
    p.add_argument("--prediction_type",
                   choices=["epsilon", "sample", "v_prediction"],
                   default="sample")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt_dir", type=str, default="ckpt_generalize")
    p.add_argument("--skip_diff", action="store_true")
    p.add_argument("--viz_dir", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def class_table(n_classes: int, tokens: int, dim: int) -> np.ndarray:
    """The script's table: float32 [n_classes, tokens, dim] from
    ``RandomState(7)``."""
    return np.random.RandomState(7).randn(n_classes, tokens,
                                          dim).astype(np.float32)


# -- the oracle -----------------------------------------------------------

def cls_collate(coords_list, *, cls_points: int, rng: np.random.RandomState,
                capacity: int):
    """Voxel-coordinate clouds → the classifier's (cpad, valid, fpad): each
    cloud subsampled to ``cls_points`` points (with replacement, from
    ``rng``), centred on its bounding box, scaled to the unit sphere (the
    features) and quantised at ``(x + 1) / 0.05`` (the coordinates)."""
    unit = []
    for c in coords_list:
        c = np.asarray(c, np.float32)
        x = c[rng.randint(0, len(c), cls_points)]
        x = x - 0.5 * (x.max(0) + x.min(0))
        unit.append(x / max(np.linalg.norm(x, axis=1).max(), 1e-6))
    return collate_fields([(u + 1.0) / VOXEL_SIZE for u in unit], unit,
                          capacity)


class Oracle:
    """The script's classifier: a `MinkowskiFCNN` over ``batch_size``
    clouds of ``cls_points`` points, its optimizer (clip 1.0, Adam on
    ``warmup_cosine(lr, 20, steps)``), and ``classify``."""

    def __init__(self, n_classes: int, *, batch_size: int, cls_points: int,
                 lr: float, steps: int, rng: np.random.RandomState, device,
                 seed: int = 0):
        self.b, self.cls_points, self.rng = batch_size, cls_points, rng
        self.capacity = batch_size * cls_points
        self.device = torch.device(device)
        self.model = MinkowskiFCNN(out_channel=n_classes,
                                   voxel_capacity=self.capacity,
                                   device=device, seed=seed)
        self.state = TrainState(self.model, canvas_vae_optimizer(
            self.model.parameters(), lr, steps))
        self.step_fn = make_train_step(self.loss_fn)

    def field(self, coords_list) -> TensorField:
        cpad, valid, fpad = cls_collate(
            coords_list, cls_points=self.cls_points, rng=self.rng,
            capacity=self.capacity)

        def t(a):
            return torch.as_tensor(a, device=self.device)
        return TensorField(coordinates=t(cpad), features=t(fpad),
                           valid=t(valid), batch_size=self.b,
                           extent=CLS_EXTENT)

    def loss_fn(self, model, batch):
        field, labels = batch
        logits = model(field)
        labels = torch.as_tensor(np.asarray(labels),
                                 device=self.device).long()
        return F.cross_entropy(logits, labels), {
            "acc": (logits.argmax(-1) == labels).float().mean()}

    def step(self, samples):
        return self.step_fn(self.state, (
            self.field([s["coords"] for s in samples]),
            [s["label"] for s in samples]))

    @torch.no_grad()
    def classify(self, coords_list) -> list:
        """The predicted class of each voxel cloud in ``.eval()``, in
        batches (the last padded with its own last cloud); -1 for an
        empty cloud."""
        self.model.eval()
        preds = []
        for i in range(0, len(coords_list), self.b):
            chunk = list(coords_list[i:i + self.b])
            padded = chunk + [chunk[-1]] * (self.b - len(chunk))
            nonempty = [c if len(c) else np.zeros((1, 3)) for c in padded]
            pr = self.model(self.field(nonempty)).argmax(-1).cpu().numpy()
            preds += [int(pr[j]) if len(c) else -1
                      for j, c in enumerate(chunk)]
        return preds


def confusion_matrix(preds, trues, n_classes: int) -> np.ndarray:
    """Row-normalised [true, pred] counts (empty predictions left out)."""
    confusion = np.zeros((n_classes, n_classes))
    for p, t in zip(preds, trues):
        if p >= 0:
            confusion[t, p] += 1
    return confusion / np.maximum(confusion.sum(1, keepdims=True), 1.0)


def confusion_correct(conf_norm: np.ndarray,
                      pred_hist: np.ndarray) -> np.ndarray:
    """The true generated-class distribution ``p`` estimated from the
    oracle's prediction histogram ``q``: ``q = Mᵀ p`` with ``M`` the
    row-stochastic confusion matrix, by least squares, clipped to the
    simplex."""
    q = pred_hist / max(pred_hist.sum(), 1.0)
    p, *_ = np.linalg.lstsq(conf_norm.T, q, rcond=None)
    p = np.clip(p, 0.0, None)
    return p / max(p.sum(), 1e-9)


def wilson_halfwidth(acc: float, n: int, z: float = 1.96) -> float:
    """The 95% Wilson interval of ``acc`` over ``n`` draws, reported as
    ``acc ± max(acc − lo, hi − acc)``."""
    center = (acc + z * z / (2 * n)) / (1 + z * z / n)
    half = (z / (1 + z * z / n)) * float(
        np.sqrt(acc * (1 - acc) / n + z * z / (4 * n * n)))
    return max(acc - (center - half), (center + half) - acc)


def score_class(preds, label: int, conf_norm: np.ndarray) -> dict:
    """One (scale, class) cell: the conditional accuracy, its Wilson
    half-width, the prediction histogram, the oracle-corrected share."""
    n_classes = conf_norm.shape[0]
    acc = float(np.mean([p == label for p in preds]))
    hist = np.zeros(n_classes)
    for p in preds:
        if p >= 0:
            hist[p] += 1
    return {"acc": acc, "ci": wilson_halfwidth(acc, len(preds)),
            "hist": hist, "empty": sum(1 for p in preds if p < 0),
            "corrected": float(confusion_correct(conf_norm, hist)[label])}


@torch.no_grad()
def generate_class(vae, unet, sched, table, template, target_grid, *,
                   label: int, scale: float, seed: int, sample_steps: int,
                   vae_scale: float):
    """One batch of class ``label`` sampled from noise on the canvas with
    classifier-free guidance at ``scale``, decoded (eval mode)."""
    vae.eval()
    unet.eval()
    b = template.batch_size
    ehs = table[torch.full((b,), label, dtype=torch.long,
                           device=table.device)]
    z = sample_latent(unet, sched, template,
                      num_inference_steps=sample_steps,
                      encoder_hidden_state=ehs, guidance_scale=scale,
                      generator=make_generator(seed, table.device))
    _, _, sout = vae.decode(z.with_features(z.features / vae_scale),
                            target_grid)
    return sout


def main(argv=None) -> dict:
    cfg = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    res, b, cap = cfg.resolution, cfg.batch_size, cfg.input_capacity
    dev = resolve_device(cfg.device)
    kw = dict(resolution=res, points_per_shape=cfg.points, seed=cfg.seed,
              composite_prob=cfg.composite_prob)
    train_ds = ProceduralShapes(num_samples=cfg.train_shapes, split="train",
                                **kw)
    val_ds = ProceduralShapes(num_samples=cfg.val_shapes, split="val", **kw)
    oracle_ds = ProceduralShapes(num_samples=cfg.oracle_shapes,
                                 split="val", **kw)
    classes = train_ds.CLASSES
    n_classes = len(classes)
    np_rng = np.random.RandomState(cfg.seed + 1)
    if cfg.stream:
        counter = itertools.count()

        def next_samples():
            return [train_ds[next(counter)] for _ in range(b)]
        next_batch = shape_stream(train_ds, b, cap, 3)
    else:
        pool = [train_ds[i] for i in range(cfg.train_shapes)]

        def next_samples():
            return [pool[i] for i in np_rng.randint(0, cfg.train_shapes, b)]

        def next_batch():
            return collate(next_samples(), cap)

    # 1. the oracle
    oracle = Oracle(n_classes, batch_size=b, cls_points=cfg.cls_points,
                    lr=cfg.lr_cls, steps=cfg.steps_cls, rng=np_rng,
                    device=dev, seed=cfg.seed)
    t0 = time.time()
    for step in range(1, cfg.steps_cls + 1):
        loss, aux = oracle.step(next_samples())
        if step % 100 == 0 or step == cfg.steps_cls:
            log.info("cls step %d loss %.4f acc %.3f (%.2f s/step)", step,
                     float(loss), float(aux["acc"]),
                     (time.time() - t0) / step)
    oracle_samples = [oracle_ds[i] for i in range(cfg.oracle_shapes)]
    val_pred = oracle.classify([s["coords"] for s in oracle_samples])
    val_true = [s["label"] for s in oracle_samples]
    cls_val_acc = float(np.mean([p == t for p, t in zip(val_pred,
                                                         val_true)]))
    conf_norm = confusion_matrix(val_pred, val_true, n_classes)
    per_cls_oracle = {name: float(conf_norm[i, i])
                      for i, name in enumerate(classes)}
    log.info("classifier held-out val acc: %.4f (%d shapes; per-class %s)",
             cls_val_acc, cfg.oracle_shapes, per_cls_oracle)

    # 2. conditional diffusion on the frozen VAE's canvas
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
    sched = DDPMScheduler.create(prediction_type=cfg.prediction_type)
    if cfg.skip_diff:
        log.info("restored cond diffusion at step %d", state.step)
    else:
        log.info("cond diffusion from step %d", state.step)
        step_fn = make_train_step(build_diffusion_loss_fn(
            vae, sched, vae_scale=cfg.vae_scale,
            prediction_type=cfg.prediction_type, device=dev,
            cond_table=table, cond_dropout=cfg.cond_dropout, **sizes))
        result["diff_loss_last"] = run_steps(
            "cond diff", state, step_fn, next_batch,
            make_generator(cfg.seed, dev), cfg.steps_diff, ckpt, 200)
    result["steps_diff"] = state.step

    # 3. sample each class on the canvas, decode, classify
    tgt0 = build_input(collate([val_ds[i] for i in range(b)], cap),
                       device=dev, **sizes).grid
    canvas = canvas_grid(b, (res,) * 3, (8,) * 3, device=dev)
    template = SparseTensor(grid=canvas, features=torch.zeros(
        (canvas.capacity, cfg.vae_channel[-1]), device=dev))
    table_now = getattr(model, "cond_table", table).detach()

    def generate(label, scale, seed):
        return generate_class(vae, unet, sched, table_now, template, tgt0,
                              label=label, scale=scale, seed=seed,
                              sample_steps=cfg.sample_steps,
                              vae_scale=cfg.vae_scale)

    sweep, best = {}, None
    for scale in cfg.cfg_scales:
        per_class, per_class_corr, per_class_ci = {}, {}, {}
        for label in range(n_classes):
            clouds = []
            for r in range(cfg.rounds):
                sets = voxel_sets(generate(
                    label, float(scale),
                    cfg.seed + 997 * label + 31 * r + int(scale * 7919)))
                for j in range(b):
                    vox = sets.get(j, set())
                    clouds.append(np.array(sorted(vox), np.int64).reshape(
                        -1, 3) if vox else np.zeros((0, 3), np.int64))
            cell = score_class(oracle.classify(clouds), label, conf_norm)
            name = classes[label]
            per_class[name] = cell["acc"]
            per_class_ci[name] = cell["ci"]
            per_class_corr[name] = cell["corrected"]
            log.info("cfg %s: class %s -> conditional acc %.3f +-%.3f "
                     "(n=%d, empty=%d); oracle-corrected true-class share "
                     "%.3f; pred hist %s", scale, name, cell["acc"],
                     cell["ci"], len(clouds), cell["empty"],
                     cell["corrected"], cell["hist"].astype(int).tolist())
        sweep[str(scale)] = {
            "per_class": per_class, "per_class_ci95": per_class_ci,
            "per_class_oracle_corrected": per_class_corr,
            "mean": float(np.mean(list(per_class.values()))),
            "mean_oracle_corrected": float(np.mean(
                list(per_class_corr.values()))),
            "samples_per_class": cfg.rounds * b}
        if best is None or sweep[str(scale)]["mean"] > best[1]:
            best = (str(scale), sweep[str(scale)]["mean"])

    if cfg.viz_dir:
        from ..utils.viz import render_pointclouds, sparse_tensor_clouds

        clouds = [sparse_tensor_clouds(generate(
            label, float(best[0]), cfg.seed + 977 + label), 1)[0]
            for label in range(n_classes)]
        log.info("render: %s", render_pointclouds(
            clouds, os.path.join(cfg.viz_dir, "cond_control.png"),
            titles=[f"cond: {c} (cfg {best[0]})" for c in classes],
            resolution=res))

    result.update({"classifier_val_acc": cls_val_acc,
                   "classifier_val_per_class": per_cls_oracle,
                   "oracle_confusion": conf_norm.tolist(),
                   "oracle_shapes": cfg.oracle_shapes,
                   "cfg_sweep": sweep, "best_scale": best[0],
                   "best_mean_conditional_acc": best[1],
                   "stream": cfg.stream})
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
