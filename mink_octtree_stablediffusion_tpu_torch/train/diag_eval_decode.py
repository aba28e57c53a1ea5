"""The train-BCE vs eval-IoU gap, level by level: the counterpart of
`scripts/diag_eval_decode.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.diag_eval_decode
    python -m mink_octtree_stablediffusion_tpu_torch.train.diag_eval_decode \\
        --device cpu --resolution 16 --points 2048 --input_capacity 4096 \\
        --vae_channel 8 16 16 16 4 --steps_vae 3

Trains the VAE on one fixed batch of `SyntheticShapes` (as
`train.e2e_quality`'s phase 1), then walks the pruning decoder level by
level in eval mode and in train mode (the targets force-kept), and
reports per level: the candidate rows against the level's capacity
(``saturated``: growth overflow), the target rows among them, the rows
kept (logit > 0), and the recall and precision of keep ∩ target
(``level_table``).  Same flags and defaults as the script (resolution 64,
32,768 points a shape, batch 4, 65,536 input rows, VAE (32, 128, 512, 512,
4), 1,500 steps, lr 1e-3, seed 0), plus ``--device`` (default: the card).
The train-mode walk leaves the BatchNorm statistics as they were, as the
script discards its ``batch_stats`` update.

Prints the script's lines; ``main`` also returns both tables and both
reconstruction IoUs (``eval_table``, ``train_table``, ``eval_iou``,
``train_iou``).  ``main(argv, on_step)`` calls ``on_step("vae", step,
loss, aux)`` after every training step.
"""

from __future__ import annotations

import argparse
import copy
import sys

import numpy as np
import torch

from ..serve import capacities
from ..utils.device import make_generator, resolve_device
from .e2e_quality import (fixed_batch, iou, overfit_vae, train_vae_overfit,
                          voxel_sets)
from .generalize import build_input


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--points", type=int, default=32768)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--input_capacity", type=int, default=65536)
    p.add_argument("--vae_channel", type=int, nargs=5,
                   default=[32, 128, 512, 512, 4])
    p.add_argument("--steps_vae", type=int, default=1500)
    p.add_argument("--lr_vae", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def level_table(out_clss, targets) -> list:
    """Per decoder level, from its logits tensor and its membership
    targets: capacity, candidates (valid rows), saturated (candidates ≥
    capacity), target (target ∩ valid), keep (logit > 0 ∩ valid), recall
    (|keep ∩ target| / |target|) and precision (/ |keep|), each of an
    empty set taken over 1."""
    rows = []
    for lt, tg in zip(out_clss, targets):
        v = lt.valid.cpu().numpy()
        lo = lt.features[:, 0].float().cpu().numpy()
        t = tg.cpu().numpy() & v
        keep = (lo > 0) & v
        inter = int((keep & t).sum())
        rows.append({"capacity": int(lt.capacity),
                     "candidates": int(v.sum()),
                     "saturated": bool(v.sum() >= lt.capacity),
                     "target": int(t.sum()), "keep": int(keep.sum()),
                     "recall": inter / max(int(t.sum()), 1),
                     "precision": inter / max(int(keep.sum()), 1)})
    return rows


@torch.no_grad()
def decode_walk(vae, st, train: bool, seed: int):
    """(out_clss, targets, sout) of one forward of ``vae`` on ``st`` in
    eval mode or in train mode (force-keep), the reparameterisation noise
    from ``seed``; a train-mode walk puts the BatchNorm statistics back."""
    was = vae.training
    saved = copy.deepcopy(dict(vae.named_buffers())) if train else None
    vae.train(train)
    out_clss, targets, sout, *_ = vae(
        st, st.grid, generator=make_generator(seed, st.C.device))
    vae.train(was)
    if saved is not None:
        for name, buf in vae.named_buffers():
            buf.copy_(saved[name])
    return out_clss, targets, sout


def main(argv=None, on_step=None) -> dict:
    cfg = parse_args(argv)
    dev = resolve_device(cfg.device)
    cap, b = cfg.input_capacity, cfg.batch_size
    batch = fixed_batch(cfg)
    print("input valid voxels:", int(np.asarray(batch[1]).sum()), "/", cap)
    enc_caps, dec_caps = capacities(cap)
    print("enc caps:", enc_caps, "dec caps:", dec_caps)
    vae = overfit_vae(cfg, dev)
    train_vae_overfit(
        cfg, vae, batch, dev, lambda step, loss, aux, sps:
        f"vae step {step} bce {float(aux['bce']):.6f} ({sps:.2f} s/step)",
        300, on_step)

    st_in = build_input(batch, input_capacity=cap, batch_size=b,
                        resolution=cfg.resolution, device=dev)
    out_clss, targets, sout = decode_walk(vae, st_in, False, cfg.seed)
    eval_table = level_table(out_clss, targets)
    for lvl, r in enumerate(eval_table):
        print(f"level {lvl}: cap={r['capacity']} candidates="
              f"{r['candidates']} (saturated={r['saturated']}) "
              f"target={r['target']} keep={r['keep']} "
              f"recall={r['recall']:.4f} precision={r['precision']:.4f}",
              flush=True)
    rec = iou(voxel_sets(st_in), voxel_sets(sout))
    print("eval reconstruction IoU:", round(rec, 4))

    # same walk in TRAIN mode (force-keep) for contrast
    out_clss2, targets2, sout2 = decode_walk(vae, st_in, True, cfg.seed)
    train_table = level_table(out_clss2, targets2)
    for lvl, r in enumerate(train_table):
        print(f"[train-mode] level {lvl}: candidates={r['candidates']} "
              f"target={r['target']} keep={r['keep']} "
              f"recall={r['recall']:.4f}", flush=True)
    rec2 = iou(voxel_sets(st_in), voxel_sets(sout2))
    print("train-mode (force-keep) reconstruction IoU:", round(rec2, 4))
    return {"eval_table": eval_table, "train_table": train_table,
            "eval_iou": rec, "train_iou": rec2}


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
