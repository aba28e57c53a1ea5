"""Latent-diffusion sampling (port of `diffusion/module.py::sample_latent`).

Denoises N(0,1) features on a *fixed* latent coordinate set with a Python
loop over the scheduler's timesteps (the JAX package's `lax.scan`).  JAX's
random streams cannot be reproduced in PyTorch, so the initial noise and
the per-step noises can be passed in (``init_noise``, ``step_noises``);
otherwise they are drawn from ``generator``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..tensor import SparseTensor


def _needs_step_noise(scheduler) -> bool:
    return getattr(scheduler, "eta", 1.0) > 0.0


def sample_latent(unet_apply: Callable, scheduler,
                  latent_template: SparseTensor,
                  num_inference_steps: int = 50,
                  encoder_hidden_state: Optional[torch.Tensor] = None,
                  guidance_scale: float = 1.0,
                  uncond_hidden_state: Optional[torch.Tensor] = None,
                  steps_offset: int = 0,
                  generator: Optional[torch.Generator] = None,
                  init_noise: Optional[torch.Tensor] = None,
                  step_noises: Optional[Sequence[torch.Tensor]] = None
                  ) -> SparseTensor:
    """``unet_apply(noised, timesteps, encoder_hidden_state)`` → the model
    output tensor.  Classifier-free guidance: with ``guidance_scale != 1``
    and a conditioning ``encoder_hidden_state`` the model runs twice per
    step and the outputs combine as ``uncond + scale·(cond − uncond)``
    (``uncond_hidden_state`` defaults to zeros)."""
    ts = [int(t) for t in scheduler.timestep_schedule(num_inference_steps,
                                                      steps_offset)]
    prev_ts = ts[1:] + [-1]
    feats = latent_template.features
    x = (init_noise if init_noise is not None else
         torch.randn(feats.shape, generator=generator, dtype=feats.dtype,
                     device=feats.device))
    use_cfg = guidance_scale != 1.0 and encoder_hidden_state is not None
    if use_cfg and uncond_hidden_state is None:
        uncond_hidden_state = torch.zeros_like(encoder_hidden_state)
    bsz = latent_template.batch_size
    for i, (t, pt) in enumerate(zip(ts, prev_ts)):
        noised = latent_template.with_features(x)
        t_b = torch.full((bsz,), t, dtype=torch.int32, device=feats.device)
        out = unet_apply(noised, t_b, encoder_hidden_state).features
        if use_cfg:
            out_uncond = unet_apply(noised, t_b, uncond_hidden_state).features
            out = out_uncond + guidance_scale * (out - out_uncond)
        if step_noises is not None:
            noise = step_noises[i]
        elif _needs_step_noise(scheduler):
            noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                device=x.device)
        else:
            noise = None  # deterministic DDIM (eta = 0) draws nothing
        x = scheduler.step(out, t, pt, x, noise)
    return latent_template.with_features(x)
