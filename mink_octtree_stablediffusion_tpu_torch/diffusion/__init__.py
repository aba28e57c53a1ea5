"""Schedulers and latent sampling."""

from .module import sample_latent
from .schedulers import DDIMScheduler, DDPMScheduler, make_betas
