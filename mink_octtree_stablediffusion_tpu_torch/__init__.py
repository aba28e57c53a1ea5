"""PyTorch/CUDA port of `mink_octtree_stablediffusion_tpu`.

The JAX package stays the reference; this package mirrors its module names
and runs the generation path (VAE encode → DDIM on the fixed latent grid →
pruning decode) and VAE training (`train.vae`) with PyTorch.  Every
bounded-grid sparse conv that is not densified goes through hand-written
CUDA kernels, forward and backward (`ops/fused_conv.py`, `csrc/`).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.  It imports neither
JAX nor anything of the JAX package.
"""

from . import data, diffusion, models, nn, ops, serve, train, utils
from .ops.coords import SparseGrid
from .tensor import SparseTensor, cat, sparse_tensor

__all__ = ["data", "diffusion", "models", "nn", "ops", "serve", "train",
           "utils",
           "SparseGrid", "SparseTensor", "cat", "sparse_tensor"]
