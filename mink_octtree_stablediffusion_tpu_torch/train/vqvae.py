"""VQ-VAE training: the counterpart of `examples/train_vqvae.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.vqvae --steps 10
    python -m mink_octtree_stablediffusion_tpu_torch.train.vqvae \\
        --device cpu --resolution 32 --input_capacity 4096 \\
        --vae_channel 8 16 32 32 4 --num_embeddings 16 --steps 2 \\
        --ckpt_dir ckpt_vqvae_tiny

Same flags and defaults as the JAX example (resolution 128, batch 4,
``max_batch_len`` 200,000, the VAE's widths (32, 128, 512, 512, 4) with
`serve.capacities`' schedule for 65,536 input rows, 512 codes, Adam at lr
1e-3, seed 42, synthetic shapes; ``--data <root>`` without ``--synthetic``
reads ModelNet40's training meshes, after the first batch's samples, as
the example), plus ``--device`` (default: the card).
A step encodes, quantizes (nearest code, straight-through) and decodes
against the input's own grid in ``.train()``; the loss is the mean
per-level occupancy BCE plus both commitment terms
(``‖zq − sg(ze)‖² + ‖sg(zq) − ze‖²``), then one Adam step.  The run resumes
from the latest checkpoint in ``--ckpt_dir`` (default ``ckpt_vqvae``; give
each run its own directory to start afresh) and checkpoints every
``--save_every`` steps and at the end.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

from ..data import batch_iterator, collate_pointclouds
from ..models import VQVAE, occupancy_bce
from ..serve import capacities
from ..tensor import sparse_tensor
from ..utils.device import resolve_device
from .diffusion import open_dataset
from .optim import vae_optimizer
from .trainer import CheckpointManager, TrainState, make_train_step

log = logging.getLogger("train_vqvae")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_batch_len", type=int, default=200_000)
    p.add_argument("--vae_channel", type=int, nargs=5,
                   default=[32, 128, 512, 512, 4])
    p.add_argument("--num_embeddings", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--ckpt_dir", type=str, default="ckpt_vqvae")
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--input_capacity", type=int, default=65536)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def build_model(*, vae_channel, num_embeddings: int, input_capacity: int,
                device, seed: int = 0) -> VQVAE:
    enc_caps, dec_caps = capacities(input_capacity)
    return VQVAE(channels=tuple(vae_channel), num_embeddings=num_embeddings,
                 encoder_capacities=enc_caps, decoder_capacities=dec_caps,
                 device=device, seed=seed)


def build_loss_fn(*, input_capacity: int, batch_size: int, resolution: int,
                  device):
    """``loss_fn(model, batch, generator=None) -> (loss, {"bce", "vq"})``
    for a collated ``(cpad, valid)``: the input's occupancy as its one
    feature, decoded against its own grid."""

    def loss_fn(model, batch, generator=None):
        cpad, valid = (torch.as_tensor(a, device=device) for a in batch[:2])
        st = sparse_tensor(cpad, valid[:, None].float(),
                           capacity=input_capacity, batch_size=batch_size,
                           valid=valid, extent=(resolution,) * 3)
        out_clss, targets, _, _, _, vq_loss = model(st, st.grid, generator)
        bce = occupancy_bce(out_clss, targets)
        return bce + vq_loss, {"bce": bce, "vq": vq_loss}

    return loss_fn


def main(argv=None) -> dict:
    cfg = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(cfg.device)
    np_rng = np.random.RandomState(cfg.seed)
    ds = open_dataset(cfg)
    cap, b = cfg.input_capacity, cfg.batch_size
    # the example's initial reads, which move a mesh dataset's generator
    [ds[i] for i in range(b)]
    net = build_model(vae_channel=cfg.vae_channel,
                      num_embeddings=cfg.num_embeddings,
                      input_capacity=cap, device=dev, seed=cfg.seed)
    log.info("params: %d", sum(p.numel() for p in net.parameters()))
    state = TrainState(net, vae_optimizer(net.parameters(), cfg.lr))
    ckpt = CheckpointManager(cfg.ckpt_dir)
    state = ckpt.restore(state)
    log.info("resumed at step %d", state.step)
    step_fn = make_train_step(build_loss_fn(
        input_capacity=cap, batch_size=b, resolution=cfg.resolution,
        device=dev))
    t0 = time.time()
    while True:
        for samples in batch_iterator(ds, b, np_rng):
            batch = collate_pointclouds([s["coords"] for s in samples], cap,
                                        cfg.max_batch_len)[:2]
            loss, aux = step_fn(state, batch)
            step = state.step
            if step % 10 == 0:
                log.info("step %d loss %.5f bce %.5f vq %.5f (%.2f s/step)",
                         step, float(loss), float(aux["bce"]),
                         float(aux["vq"]), (time.time() - t0) / 10)
                t0 = time.time()
            if step % cfg.save_every == 0:
                ckpt.save(step, state)
            if cfg.steps and step >= cfg.steps:
                ckpt.save(step, state)
                out = {"final_loss": float(loss), "bce": float(aux["bce"]),
                       "vq": float(aux["vq"]), "step": step}
                log.info("done (step cap)")
                print(json.dumps(out), flush=True)
                return out


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
