"""Models: the octree VAE (with its loss) and the latent UNet."""

from .unet import UNet
from .vae import VAE, Decoder, Encoder, vae_loss
