"""Models: the octree VAE (with its loss), the latent UNet, and the model
zoo: the VQ-VAE, the sparse ResNet and ModelNet40 classifiers, PointNet,
the MinkUNet segmentation family, generative reconstruction and
completion, and the dense 3D UNets."""

from .classification import MinkowskiFCNN, MinkowskiSplatFCNN, field_slice
from .completion import CompletionNet, GenerativeNet
from .dense_unet import (Attention3D, DenseAttention, DenseTransformer3D,
                         Downsample3D, ResnetBlock3D, UNet3DConditionModel,
                         UNet3DModel, Upsample3D)
from .minkunet import (MinkUNet14, MinkUNet18, MinkUNet34, MinkUNet34A,
                       MinkUNet34B, MinkUNet34C, MinkUNet50, MinkUNet101,
                       MinkUNetBase)
from .pointnet import MinkowskiPointNet, PointNet
from .resnet import (ResNet14, ResNet18, ResNet34, ResNet50, ResNet101,
                     ResNetBase)
from .unet import UNet
from .vae import VAE, Decoder, Encoder, occupancy_bce, vae_loss
from .vqvae import VQVAE, VectorQuantizer
