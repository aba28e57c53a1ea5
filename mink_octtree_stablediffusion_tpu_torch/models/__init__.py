"""Models: the octree VAE (with its loss), the latent UNet and the sparse
ResNet classifiers."""

from .resnet import (ResNet14, ResNet18, ResNet34, ResNet50, ResNet101,
                     ResNetBase)
from .unet import UNet
from .vae import VAE, Decoder, Encoder, vae_loss
