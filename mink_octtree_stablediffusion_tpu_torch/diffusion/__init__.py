"""Schedulers, diffusion training losses, latent sampling and noise
points."""

from .module import (CoordNLLParams, add_noise_per_instance, coord_nll,
                     denoise_loss, diffusion_training_loss, sample_latent)
from .schedulers import DDIMScheduler, DDPMScheduler, make_betas
from .noise_points import inject_noise_points, uniform_points
