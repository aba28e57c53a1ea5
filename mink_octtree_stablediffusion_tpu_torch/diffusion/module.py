"""Latent-diffusion training and sampling.

Port of `mink_octtree_stablediffusion_tpu/diffusion/module.py`.  Training:
the clean latent's features are noised with one timestep per batch
instance, the UNet predicts ε (or v, or x0 with SNR weighting), and an
auxiliary Gaussian NLL of the latent coordinates has a learnable (μ, Σ)
(``CoordNLLParams``).  Sampling denoises N(0,1) features on a *fixed*
latent coordinate set with a Python loop over the scheduler's timesteps
(the JAX package's `lax.scan`).

JAX's random streams cannot be reproduced in PyTorch, so the draws can be
passed in (``timesteps`` and ``noise`` of ``diffusion_training_loss``,
``init_noise`` and ``step_noises`` of ``sample_latent``); otherwise they
come from ``generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..ops.coords import device_const
from ..tensor import SparseTensor
from ..utils import profiling


class CoordNLLParams(nn.Module):
    """Learnable (μ, Σ) of the latent-coordinate Gaussian: μ = 0 and Σ = I
    at the start, as `CoordNLLParams.create`."""

    def __init__(self, ndim: int = 3, device=None):
        super().__init__()
        self.mu = nn.Parameter(torch.zeros(ndim, device=device))
        self.sigma = nn.Parameter(torch.eye(ndim, device=device))


def coord_nll(params: CoordNLLParams, latent: SparseTensor,
              resolution: int) -> torch.Tensor:
    """−mean log N(coords/resolution; μ, Σ) over the valid rows, with Σ
    symmetrised and jittered by 1e-4·I."""
    d = latent.grid.ndim
    x = latent.C[:, 1:].float() / float(resolution)
    eye = torch.eye(d, device=x.device)
    sym = 0.5 * (params.sigma + params.sigma.T) + 1e-4 * eye
    chol = torch.linalg.cholesky(sym)
    diff = x - params.mu[None, :]
    sol = torch.linalg.solve_triangular(chol, diff.T, upper=False)
    maha = (sol ** 2).sum(0)
    logdet = 2.0 * torch.log(torch.diagonal(chol)).sum()
    ll = -0.5 * (maha + logdet + d * math.log(2.0 * math.pi))
    v = latent.valid.float()
    return -(ll * v).sum() / v.sum().clamp(min=1.0)


def _row_instance(latent: SparseTensor) -> torch.Tensor:
    """Batch instance of each row, padding rows clipped to the last."""
    return latent.grid.batch_ids().clamp(0, latent.batch_size - 1).long()


def add_noise_per_instance(scheduler, latent: SparseTensor,
                           timesteps: torch.Tensor,
                           noise: torch.Tensor) -> SparseTensor:
    """x_t with each batch instance at its own timestep: each row reads its
    instance's t through the batch column."""
    row_t = timesteps[_row_instance(latent)]
    return latent.with_features(
        scheduler.add_noise(latent.features, noise, row_t))


def denoise_loss(scheduler, model_output: SparseTensor, latent: SparseTensor,
                 noise: torch.Tensor, timesteps: torch.Tensor,
                 prediction_type: str = "epsilon") -> torch.Tensor:
    """Masked MSE against ε (``epsilon``) or v (``v_prediction``), or the
    SNR-weighted per-instance MSE against x0 (``sample``)."""
    v = model_output.valid.float()[:, None]
    if prediction_type in ("epsilon", "v_prediction"):
        target = noise if prediction_type == "epsilon" else \
            scheduler.get_velocity(latent.features, noise,
                                   timesteps[_row_instance(latent)])
        se = (model_output.features - target) ** 2 * v
        return se.sum() / (v.sum() * noise.shape[1]).clamp(min=1.0)
    # sample prediction: per-instance mean MSE weighted by SNR = ᾱ/(1−ᾱ)
    ac = device_const(scheduler.alphas_cumprod, torch.float32,
                      timesteps.device)[timesteps.long()]
    snr = ac / (1.0 - ac)
    bid = latent.grid.batch_ids().long()
    se = ((model_output.features - latent.features) ** 2).mean(-1)
    se = se * model_output.valid.to(se.dtype)
    nseg = latent.batch_size + 1
    num = se.new_zeros(nseg).index_add(0, bid, se)
    cnt = se.new_zeros(nseg).index_add(0, bid,
                                       model_output.valid.to(se.dtype))
    per_inst = num[:-1] / cnt[:-1].clamp(min=1.0)
    return (snr * per_inst).mean()


def diffusion_training_loss(unet_apply: Callable, scheduler,
                            latent: SparseTensor,
                            nll_params: Optional[CoordNLLParams] = None,
                            resolution: int = 128,
                            prediction_type: str = "epsilon",
                            nll_weight: float = 0.01,
                            encoder_hidden_state: Optional[torch.Tensor] = None,
                            timesteps: Optional[torch.Tensor] = None,
                            noise: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None):
    """One training-loss evaluation → (loss, aux).  ``latent`` is the clean
    latent, already scaled by ``vae_scale``; ``unet_apply(noised,
    timesteps, encoder_hidden_state)`` closes over the UNet.  ``timesteps``
    (int, one per instance) and ``noise`` (the features' shape) are drawn
    from ``generator`` where not given."""
    feats = latent.features
    if timesteps is None:
        timesteps = torch.randint(0, scheduler.num_train_timesteps,
                                  (latent.batch_size,), generator=generator,
                                  device=feats.device, dtype=torch.int32)
    if noise is None:
        noise = torch.randn(feats.shape, generator=generator,
                            dtype=feats.dtype, device=feats.device)
    noised = add_noise_per_instance(scheduler, latent, timesteps, noise)
    model_output = unet_apply(noised, timesteps, encoder_hidden_state)
    loss = denoise_loss(scheduler, model_output, latent, noise, timesteps,
                        prediction_type)
    aux = {"denoise_loss": loss}
    if nll_params is not None:
        nll = coord_nll(nll_params, latent, resolution)
        aux["nll_loss"] = nll
        loss = loss + nll_weight * nll
    return loss, aux


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
    (``uncond_hidden_state`` defaults to zeros).  Profiling spans
    (``utils.profiling``): ``sample.step`` a step, with ``unet.forward``
    around each model call and ``scheduler.step`` inside it."""
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
        with profiling.span("sample.step"):
            noised = latent_template.with_features(x)
            t_b = torch.full((bsz,), t, dtype=torch.int32,
                             device=feats.device)
            with profiling.span("unet.forward"):
                out = unet_apply(noised, t_b, encoder_hidden_state).features
            if use_cfg:
                with profiling.span("unet.forward"):
                    out_uncond = unet_apply(noised, t_b,
                                            uncond_hidden_state).features
                out = out_uncond + guidance_scale * (out - out_uncond)
            if step_noises is not None:
                noise = step_noises[i]
            elif _needs_step_noise(scheduler):
                noise = torch.randn(x.shape, generator=generator,
                                    dtype=x.dtype, device=x.device)
            else:
                noise = None  # deterministic DDIM (eta = 0) draws nothing
            with profiling.span("scheduler.step"):
                x = scheduler.step(out, t, pt, x, noise)
    return latent_template.with_features(x)
