"""DDPM / DDIM schedulers.

Port of `mink_octtree_stablediffusion_tpu/diffusion/schedulers.py`.  The
α/β tables are float32 numpy arrays on the host and the timesteps of a
sampling loop are plain Python ints, so a step's coefficients are float32
host scalars: the loop never reads the device.  The arithmetic on the
coefficients is done in float32, as the JAX package does on its float32
tables.  Training's ``add_noise`` and ``get_velocity`` take per-row
timesteps as a tensor and gather ᾱ on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.coords import device_const

_F = np.float32


def make_betas(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012, beta_schedule: str = "scaled_linear"
               ) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=np.float64) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        ts = np.arange(num_train_timesteps, dtype=np.float64)
        return np.minimum(
            1 - alpha_bar((ts + 1) / num_train_timesteps) /
            alpha_bar(ts / num_train_timesteps), 0.999)
    raise ValueError(beta_schedule)


def _sqrt(v) -> float:
    return float(np.sqrt(_F(v)))


class DDPMScheduler(NamedTuple):
    betas: np.ndarray  # float32
    alphas_cumprod: np.ndarray  # float32
    num_train_timesteps: int
    prediction_type: str
    clip_sample: bool
    variance_type: str

    @classmethod
    def create(cls, num_train_timesteps: int = 1000,
               beta_start: float = 0.00085, beta_end: float = 0.012,
               beta_schedule: str = "scaled_linear",
               prediction_type: str = "epsilon", clip_sample: bool = False,
               variance_type: str = "fixed_small") -> "DDPMScheduler":
        betas = make_betas(num_train_timesteps, beta_start, beta_end,
                           beta_schedule)
        ac = np.cumprod(1.0 - betas)
        return cls(betas.astype(_F), ac.astype(_F), num_train_timesteps,
                   prediction_type, clip_sample, variance_type)

    def _sqrt_ac(self, timesteps: torch.Tensor, ndim: int):
        """(sqrt(ᾱ_t), sqrt(1 − ᾱ_t)) in float32 for each timestep, with
        trailing unit axes up to ``ndim``."""
        ac = device_const(self.alphas_cumprod, torch.float32,
                          timesteps.device)[timesteps.long()]
        ac = ac.reshape(ac.shape + (1,) * (ndim - ac.dim()))
        return ac.sqrt(), (1.0 - ac).sqrt()

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(ᾱ_t)·x_0 + sqrt(1−ᾱ_t)·ε; ``timesteps`` indexes
        original's leading axis (one per row, or one for all)."""
        a, b = self._sqrt_ac(timesteps, original.dim())
        return a * original + b * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        """v = sqrt(ᾱ_t)·ε − sqrt(1−ᾱ_t)·x_0."""
        a, b = self._sqrt_ac(timesteps, sample.dim())
        return a * noise - b * sample

    def _predict_x0_eps(self, model_output: torch.Tensor,
                        sample: torch.Tensor, t: int):
        ac_t = self.alphas_cumprod[t]
        if self.prediction_type == "epsilon":
            x0 = (sample - _sqrt(_F(1) - ac_t) * model_output) / _sqrt(ac_t)
            eps = model_output
        elif self.prediction_type == "sample":
            x0 = model_output
            eps = (sample - _sqrt(ac_t) * x0) / _sqrt(_F(1) - ac_t)
        elif self.prediction_type == "v_prediction":
            x0 = _sqrt(ac_t) * sample - _sqrt(_F(1) - ac_t) * model_output
            eps = _sqrt(ac_t) * model_output + _sqrt(_F(1) - ac_t) * sample
        else:
            raise ValueError(self.prediction_type)
        if self.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        return x0, eps

    def step(self, model_output: torch.Tensor, t: int, prev_t: int,
             sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """One ancestral DDPM step t → prev_t (fixed_small variance);
        ``prev_t < 0`` is the final step (no noise)."""
        ac_t = self.alphas_cumprod[t]
        ac_prev = self.alphas_cumprod[max(prev_t, 0)] if prev_t >= 0 else _F(1)
        alpha_t = _F(ac_t / ac_prev)
        beta_t = _F(1) - alpha_t
        x0, _ = self._predict_x0_eps(model_output, sample, t)
        coef_x0 = float(_F(np.sqrt(ac_prev) * beta_t / (_F(1) - ac_t)))
        coef_xt = float(_F(np.sqrt(alpha_t) * (_F(1) - ac_prev) /
                           (_F(1) - ac_t)))
        mean = coef_x0 * x0 + coef_xt * sample
        if self.variance_type == "fixed_small":
            var = max(_F((_F(1) - ac_prev) / (_F(1) - ac_t) * beta_t), 1e-20)
        elif self.variance_type == "fixed_large":
            var = max(beta_t, 1e-20)
        else:
            raise ValueError(self.variance_type)
        if prev_t < 0:
            return mean
        return mean + _sqrt(var) * noise

    def timestep_schedule(self, num_inference_steps: int,
                          steps_offset: int = 0) -> np.ndarray:
        """Evenly spaced descending timesteps ("leading" spacing)."""
        step = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step).round()[::-1].astype(
            np.int32) + steps_offset
        return np.clip(ts, 0, self.num_train_timesteps - 1).astype(np.int32)


class DDIMScheduler(NamedTuple):
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    num_train_timesteps: int
    prediction_type: str
    clip_sample: bool
    eta: float
    # ᾱ used for the final step (prev_t < 0): 1.0 returns x0 exactly
    final_alpha_cumprod: float = 1.0

    @classmethod
    def create(cls, num_train_timesteps: int = 1000,
               beta_start: float = 0.00085, beta_end: float = 0.012,
               beta_schedule: str = "scaled_linear",
               prediction_type: str = "epsilon", clip_sample: bool = False,
               eta: float = 0.0,
               set_alpha_to_one: bool = True) -> "DDIMScheduler":
        betas = make_betas(num_train_timesteps, beta_start, beta_end,
                           beta_schedule)
        ac = np.cumprod(1.0 - betas)
        final_ac = 1.0 if set_alpha_to_one else float(_F(ac[0]))
        return cls(betas.astype(_F), ac.astype(_F), num_train_timesteps,
                   prediction_type, clip_sample, eta, final_ac)

    _predict_x0_eps = DDPMScheduler._predict_x0_eps
    timestep_schedule = DDPMScheduler.timestep_schedule

    def step(self, model_output: torch.Tensor, t: int, prev_t: int,
             sample: torch.Tensor,
             noise: torch.Tensor | None = None) -> torch.Tensor:
        """One DDIM step (deterministic for eta=0)."""
        ac_t = self.alphas_cumprod[t]
        ac_prev = (self.alphas_cumprod[prev_t] if prev_t >= 0
                   else _F(self.final_alpha_cumprod))
        x0, eps = self._predict_x0_eps(model_output, sample, t)
        sigma = _F(0)
        if self.eta > 0.0:
            assert noise is not None
            sigma = _F(_F(self.eta) * np.sqrt((_F(1) - ac_prev) /
                                              (_F(1) - ac_t)) *
                       np.sqrt(_F(1) - ac_t / ac_prev))
        dir_coef = _sqrt(max(_F(_F(1) - ac_prev - sigma ** 2), _F(0)))
        prev = _sqrt(ac_prev) * x0 + dir_coef * eps
        if self.eta > 0.0:
            prev = prev + float(sigma) * noise
        return prev
