"""Training: the optimizer, the train state and step, checkpoints.  The
VAE's entry point is the module ``train.vae`` (imported on demand, so that
``python -m mink_octtree_stablediffusion_tpu_torch.train.vae`` runs it)."""

from .optim import vae_optimizer
from .trainer import CheckpointManager, TrainState, make_train_step
