"""Training: the optimizers, the train state and step, checkpoints.  The
entry points are the modules ``train.vae`` and ``train.diffusion``
(imported on demand, so that ``python -m
mink_octtree_stablediffusion_tpu_torch.train.vae`` runs them)."""

from .optim import (DiffusionOptimizer, diffusion_optimizer, vae_optimizer,
                    warmup_cosine)
from .trainer import CheckpointManager, TrainState, make_train_step
