"""Text-conditioned sparse latent diffusion: the counterpart of
`examples/diffusion_cross.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.diffusion_cross \\
        --synthetic --steps 2 --cond random --device cpu

Same flags and defaults as the example (resolution 32, batch 2, VAE (8,
16, 32, 32, 4), UNet (4, 8, 16, 16) with self- and cross-attention on a
[B, 77, ``cross_attention_dim`` 768] condition, group 4, DDPM, AdamW at
lr 1e-4 on `diffusion_optimizer`'s 1000-step warmup, 4096 input rows,
seed 42, `SyntheticShapes` with their captions "a picture of a
{class}"), plus ``--device`` (default: the card) and ``--ckpt_dir``
(default ``ckpt_diffusion_cross``): the run checkpoints the UNet and the
optimizer at the step cap and resumes from the latest checkpoint there.
The VAE is frozen with random weights of ``--seed``; its encoder's mean,
scaled by ``--vae_scale``, is the clean latent.  ``--cond random``
embeds each caption as a fixed N(0, 1) table drawn from
``RandomState(abs(hash(caption)) % 2**31)`` (Python's string hash is
salted per process, so the table is fixed within a run).  ``clip-text``
and ``clip-image`` need the `transformers` package and CLIP's weights
(``openai/clip-vit-large-patch14``), which the repository does not hold:
they raise.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

from ..data import SyntheticShapes, batch_iterator, collate_pointclouds
from ..diffusion import DDPMScheduler
from ..serve import generation_models
from ..utils.device import make_generator, resolve_device
from .diffusion import build_loss_fn
from .optim import diffusion_optimizer
from .trainer import CheckpointManager, TrainState, make_train_step


class TextEncoder:
    """caption → [S, D] embedding; ``random`` mode only: one fixed
    N(0, 1) table a caption, from ``RandomState(abs(hash(caption)) %
    2**31)``, on ``device``."""

    def __init__(self, mode: str, seq_len: int = 77, dim: int = 768,
                 device=None):
        if mode != "random":
            raise NotImplementedError(
                f"--cond {mode} needs the transformers package and CLIP's "
                "weights (openai/clip-vit-large-patch14, CLIPTextModel / "
                "CLIPVisionModel), which the repository does not hold")
        self.mode = mode
        self.seq_len, self.dim = seq_len, dim
        self.device = device
        self.cache: dict = {}

    def __call__(self, captions) -> torch.Tensor:
        rows = []
        for c in captions:
            if c not in self.cache:
                r = np.random.RandomState(abs(hash(c)) % (2 ** 31))
                self.cache[c] = r.randn(self.seq_len, self.dim).astype(
                    np.float32)
            rows.append(self.cache[c])
        return torch.as_tensor(np.stack(rows), device=self.device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--vae_channel", type=int, nargs=5,
                   default=[8, 16, 32, 32, 4])
    p.add_argument("--unet_channel", type=int, nargs=4,
                   default=[4, 8, 16, 16])
    p.add_argument("--cond", default="random",
                   choices=["random", "clip-text", "clip-image"])
    p.add_argument("--cross_attention_dim", type=int, default=768)
    p.add_argument("--group", type=int, default=4)
    p.add_argument("--vae_scale", type=float, default=0.1428)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--input_capacity", type=int, default=4096)
    p.add_argument("--ckpt_dir", type=str, default="ckpt_diffusion_cross")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("diffusion_cross")
    dev = resolve_device(args.device)
    encoder = TextEncoder(args.cond, dim=args.cross_attention_dim,
                          device=dev)
    np_rng = np.random.RandomState(args.seed)
    ds = SyntheticShapes(resolution=args.resolution, num_samples=128,
                         with_class=True)
    cap, b = args.input_capacity, args.batch_size
    # the example's UNet: down capacities from the latent capacity, the
    # default attn_max_len (256)
    vae, unet = generation_models(
        input_capacity=cap, batch_size=b, vae_channel=args.vae_channel,
        unet_channel=args.unet_channel, group=args.group, attn_max_len=256,
        with_cross_attn=True, cross_attention_dim=args.cross_attention_dim,
        device=dev, seed=args.seed)
    vae.requires_grad_(False)
    log.info("unet params: %d", sum(p.numel() for p in unet.parameters()))
    model = torch.nn.ModuleDict({"unet": unet})
    state = TrainState(model, diffusion_optimizer(model.parameters(),
                                                  args.lr))
    ckpt = CheckpointManager(args.ckpt_dir)
    state = ckpt.restore(state)
    log.info("resumed at step %d", state.step)
    loss_fn = build_loss_fn(
        vae, DDPMScheduler.create(), input_capacity=cap, batch_size=b,
        resolution=args.resolution, vae_scale=args.vae_scale,
        prediction_type="epsilon", no_vae=False, device=dev, with_nll=False)
    step_fn = make_train_step(loss_fn)
    gen = make_generator(args.seed, dev)
    t0 = time.time()
    while True:
        for samples in batch_iterator(ds, b, np_rng):
            cpad, valid, _, _ = collate_pointclouds(
                [s["coords"] for s in samples], cap)
            ehs = encoder([s["caption"] for s in samples])
            loss, _ = step_fn(state, (cpad, valid), gen,
                              encoder_hidden_state=ehs)
            step = state.step
            if step % 5 == 0 or (args.steps and step >= args.steps):
                log.info("step %d loss %.5f (%.2f s/step)", step,
                         float(loss), (time.time() - t0) / 5)
                t0 = time.time()
            if args.steps and step >= args.steps:
                ckpt.save(step, state)
                log.info("done")
                return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
