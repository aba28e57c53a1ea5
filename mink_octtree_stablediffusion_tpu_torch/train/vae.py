"""Octree sparse VAE training: the counterpart of `examples/train_vae.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.vae --steps 10
    python -m mink_octtree_stablediffusion_tpu_torch.train.vae --device cpu \\
        --resolution 32 --input_capacity 4096 --vae_channel 8 16 32 32 4 \\
        --steps 2 --ckpt_dir ckpt_vae_tiny

Same flags and defaults as the JAX example (resolution 128, batch 4,
``input_capacity`` 65536, VAE (32, 128, 512, 512, 4) with the
`capacities()` schedule, Adam at lr 1e-3, ``kld_weight`` 1e-6, synthetic
shapes), plus ``--device`` (default: the card).  Each step builds the
input tensor, runs the encoder, the reparameterisation and the pruning
decoder in train mode, takes `vae_loss`, backpropagates and steps Adam;
BatchNorm moves its running statistics.  The run resumes from the latest
checkpoint in ``--ckpt_dir`` (default ``ckpt_vae`` in the working
directory; as in the JAX example, ``--recover`` is always on, so give each
run its own directory to start afresh), logs loss, BCE and KLD every 10
steps, and checkpoints
every ``--save_every`` steps and at the end.  Not ported yet (raise): the
ModelNet40 dataset (``--data`` without ``--synthetic``) and the PNG
visualisation (``--viz_every``).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

from ..data import SyntheticShapes, batch_iterator, collate_pointclouds
from ..models.vae import VAE, vae_loss
from ..serve import capacities
from ..tensor import sparse_tensor
from ..utils.device import make_generator, resolve_device
from .optim import vae_optimizer
from .trainer import CheckpointManager, TrainState, make_train_step


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_batch_len", type=int, default=200_000)
    p.add_argument("--vae_channel", type=int, nargs=5,
                   default=[32, 128, 512, 512, 4])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--kld_weight", type=float, default=1e-6)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--steps", type=int, default=0, help="hard step cap (0=off)")
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--ckpt_dir", type=str, default="ckpt_vae")
    p.add_argument("--recover", action="store_true", default=True)
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--small_dataset", action="store_true")
    p.add_argument("--input_capacity", type=int, default=65536)
    p.add_argument("--viz_dir", type=str, default=None)
    p.add_argument("--viz_every", type=int, default=0,
                   help="render reconstruction vs input PNG every N steps")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def build_loss_fn(*, input_capacity: int, batch_size: int, resolution: int,
                  kld_weight: float, device):
    """``loss_fn(model, batch, generator=None, eps=None) -> (loss, aux)``
    of `examples/train_vae.py`: ``batch`` is a collated ``(cpad, valid,
    feats)`` (numpy or tensors); the VAE decodes against the input's own
    grid; ``eps`` (else a draw from ``generator``) is the
    reparameterisation noise."""
    dev = torch.device(device)

    def loss_fn(model, batch, generator=None, eps=None):
        cpad, valid, feats = (torch.as_tensor(np.asarray(a), device=dev)
                              for a in batch)
        st = sparse_tensor(cpad, feats, capacity=input_capacity,
                           batch_size=batch_size, valid=valid,
                           extent=(resolution,) * 3)
        out_clss, targets, _, mean, log_var, _ = model(
            st, st.grid, eps=eps, generator=generator)
        return vae_loss(out_clss, targets, mean, log_var, kld_weight)

    return loss_fn


def main(argv=None) -> int:
    cfg = parse_args(argv)
    if cfg.data is not None and not cfg.synthetic:
        raise NotImplementedError(
            "ModelNet40Dataset is not ported yet; use --synthetic")
    if cfg.viz_every:
        raise NotImplementedError("the PNG visualisation is not ported yet")
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("train_vae")
    dev = resolve_device(cfg.device)
    np_rng = np.random.RandomState(cfg.seed)
    ds = SyntheticShapes(resolution=cfg.resolution, num_samples=256)
    enc_caps, dec_caps = capacities(cfg.input_capacity)
    vae = VAE(channels=tuple(cfg.vae_channel), encoder_capacities=enc_caps,
              decoder_capacities=dec_caps, device=dev, seed=cfg.seed)
    log.info("params: %d", sum(p.numel() for p in vae.parameters()))
    state = TrainState(vae, vae_optimizer(vae.parameters(), cfg.lr))
    ckpt = CheckpointManager(cfg.ckpt_dir)
    if cfg.recover:
        state = ckpt.restore(state)
        log.info("resumed at step %d", state.step)
    step_fn = make_train_step(build_loss_fn(
        input_capacity=cfg.input_capacity, batch_size=cfg.batch_size,
        resolution=cfg.resolution, kld_weight=cfg.kld_weight, device=dev))
    gen = make_generator(cfg.seed, dev)
    t0 = time.time()
    for epoch in range(cfg.max_epochs):
        for samples in batch_iterator(ds, cfg.batch_size, np_rng):
            cpad, valid, feats, _ = collate_pointclouds(
                [s["coords"] for s in samples], cfg.input_capacity,
                cfg.max_batch_len)
            loss, aux = step_fn(state, (cpad, valid, feats), gen)
            step = state.step
            if step % 10 == 0:
                log.info("epoch %d step %d loss %.5f bce %.5f kld %.3f "
                         "(%.2f s/step)", epoch, step, float(loss),
                         float(aux["bce"]), float(aux["kld"]),
                         (time.time() - t0) / 10)
                t0 = time.time()
            if step % cfg.save_every == 0:
                ckpt.save(step, state)
                log.info("checkpointed step %d", step)
            if cfg.steps and step >= cfg.steps:
                ckpt.save(step, state)
                log.info("done (step cap) loss %.5f bce %.5f kld %.3f",
                         float(loss), float(aux["bce"]), float(aux["kld"]))
                return 0
    ckpt.save(state.step, state)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
