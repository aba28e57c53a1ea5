"""Training: the optimizers, the train state and step, checkpoints.  The
entry points are the modules ``train.vae``, ``train.diffusion``,
``train.generalize``, ``train.cond``, ``train.diffusion_cross`` and the
model zoo's ``train.classification``, ``train.segmentation``,
``train.reconstruction``, ``train.vqvae`` and ``train.diffusion_dense``,
the bf16-vs-float32 check ``train.check_bf16_training``, and the quality
and diagnosis scripts ``train.e2e_quality``, ``train.vqvae_quality``,
``train.diag_eval_decode`` and ``train.measure_occupancy`` (imported on
demand, so that ``python -m
mink_octtree_stablediffusion_tpu_torch.train.vae`` runs them)."""

from .optim import (AdafactorOptimizer, DiffusionOptimizer,
                    MixedPrecisionParams, adafactor_diffusion_optimizer,
                    canvas_vae_optimizer, cast_params, diffusion_optimizer,
                    factored_dims, vae_optimizer, warmup_cosine)
from .trainer import (CheckpointManager, TrainState, all_reduce_mean,
                      broadcast_module, make_dp_train_step, make_train_step,
                      split_device_rngs)
