"""Schedulers, diffusion training losses and latent sampling."""

from .module import (CoordNLLParams, add_noise_per_instance, coord_nll,
                     denoise_loss, diffusion_training_loss, sample_latent)
from .schedulers import DDIMScheduler, DDPMScheduler, make_betas
