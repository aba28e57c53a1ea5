"""Models of the generation path: the octree VAE and the latent UNet."""

from .unet import UNet
from .vae import VAE, Decoder, Encoder
