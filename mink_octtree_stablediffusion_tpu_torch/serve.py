"""Serving: the generation program as one callable.

Port of `mink_octtree_stablediffusion_tpu/serve.py::build_generate_fn`
(without `jax.export`): encode the conditioning sample's geometry with the
VAE encoder to fix the latent coordinate set, denoise pure N(0,1) features
with the UNet and the scheduler, decode with the pruning decoder, and
return the generated stride-1 voxel set.

``generation_models`` builds the configuration of `examples/generate.py`
(VAE with the `capacities()` schedule of `examples/train_vae.py`, UNet with
the latent-derived ``attn_max_len`` and down capacities) from the port's
own initialisers.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .diffusion.module import sample_latent
from .models.unet import UNet
from .models.vae import VAE
from .tensor import sparse_tensor
from .utils.device import resolve_device


def capacities(input_capacity: int):
    """Per-level capacity schedule (`examples/train_vae.py::capacities`):
    encoder levels shrink ~4x per octree level (surface scaling), decoder
    candidate buffers carry 2x growth slack → (encoder, decoder)."""
    c = input_capacity
    enc = tuple(max(c // d, 128) for d in (2, 4, 16)) + \
        (max(c // 16, 128),) * 2
    dec = tuple(max(c // d, 128) for d in (16, 4, 2)) + (2 * c,)
    return enc, dec


def generation_models(*, input_capacity: int, batch_size: int,
                      vae_channel: Sequence[int] = (32, 128, 512, 512, 4),
                      unet_channel: Sequence[int] = (4, 320, 640, 960),
                      group: int = 32, attn_max_len: int = 0,
                      time_embedding_norm: str = "default",
                      max_keep: Optional[int] = None, device=None,
                      seed: int = 0):
    """(vae, unet) of `examples/generate.py`'s configuration (and of
    `examples/train_diffusion.py`'s), with weights from the port's
    initialisers and a seeded generator on ``device``.  ``max_keep`` is
    the decoder's per-level top-k clamp (`VAE.max_keep`)."""
    enc_caps, dec_caps = capacities(input_capacity)
    latent_cap = enc_caps[2]
    attn_max_len = attn_max_len or max(
        -(-latent_cap * 3 // (2 * batch_size) // 128) * 128, 128)
    vae = VAE(channels=tuple(vae_channel), encoder_capacities=enc_caps,
              decoder_capacities=dec_caps, max_keep=max_keep, device=device,
              seed=seed)
    unet = UNet(channels=tuple(unet_channel), group=group,
                attn_max_len=attn_max_len,
                time_embedding_norm=time_embedding_norm,
                down_capacities=(max(latent_cap // 2, 16),
                                 max(latent_cap // 4, 8),
                                 max(latent_cap // 8, 8)),
                device=device, seed=seed + 1)
    return vae, unet


def build_generate_fn(vae: VAE, unet: UNet, scheduler, *,
                      input_capacity: int, batch_size: int, resolution: int,
                      vae_scale: float = 0.1428, sample_steps: int = 64,
                      steps_offset: int = 0, guidance_scale: float = 1.0,
                      device=None) -> Callable:
    """``fn(cpad, valid, generator=None, init_noise=None, step_noises=None,
    encoder_hidden_state=None) -> (coords, valid)`` on ``device`` (default
    ``cuda``): ``cpad`` int32 [input_capacity, 4] and ``valid`` bool
    [input_capacity] (numpy or tensors) give the conditioning voxels."""
    dev = resolve_device(device)
    vae.eval()
    unet.eval()

    @torch.no_grad()
    def fn(cpad, valid, generator: Optional[torch.Generator] = None,
           init_noise: Optional[torch.Tensor] = None,
           step_noises=None, encoder_hidden_state=None):
        cpad = torch.as_tensor(np.asarray(cpad, np.int32), device=dev)
        valid = torch.as_tensor(np.asarray(valid, bool), device=dev)
        feats = torch.ones((input_capacity, 1), device=dev) * valid[:, None]
        st = sparse_tensor(cpad, feats, capacity=input_capacity,
                           batch_size=batch_size, valid=valid,
                           extent=(resolution,) * 3)
        mean, _ = vae.encode(st)
        latent = mean.with_features(mean.features * vae_scale)
        z = sample_latent(unet, scheduler, latent,
                          num_inference_steps=sample_steps,
                          encoder_hidden_state=encoder_hidden_state,
                          guidance_scale=guidance_scale,
                          steps_offset=steps_offset, generator=generator,
                          init_noise=init_noise, step_noises=step_noises)
        z = z.with_features(z.features / vae_scale)
        _, _, sout = vae.decode(z, st.grid)
        return sout.grid.coords, sout.grid.valid

    return fn
