"""PyTorch/CUDA port of `mink_octtree_stablediffusion_tpu`.

The JAX package stays the reference; this package mirrors its module names
and runs the generation path (VAE encode → DDIM on the fixed latent grid →
pruning decode), template-free and conditioned generation on the latent
canvas, and their training (`train.vae`, `train.diffusion`,
`train.generalize`, `train.cond`, `train.diffusion_cross`) with PyTorch,
serves generation as an exported artifact (`serve.save_artifact`,
`serve.load_artifact`; `python -m ...generate`), and trains and samples
data-parallel over ``torch.distributed`` (`parallel`: process groups,
SyncBN's collective, per-rank batches; `train.make_dp_train_step`; the
sparse ResNet classifiers of `models.resnet` through `python -m
...multigpu_dp`; `parallel.dryrun`), and offers the MinkowskiEngine-style
tensor API on bounded and unbounded grids (``TensorField``, slicing,
interpolation, the dense round trip, union arithmetic, ``python -m
...api_demo``), and feeds training from mesh files (`data`'s OFF, OBJ
and GLB datasets behind every ``--data`` flag), from shapes synthesized
on the card (`data.procedural_batch`) and through a prefetching loader,
with a native host voxelizer (`native`) and the utilities of
`utils` (diagnostics, gradcheck, profiling, summaries, the import of
reference checkpoints).  Every
bounded-grid sparse conv that is not densified goes through hand-written
CUDA kernels, forward and backward (`ops/fused_conv.py`, `csrc/`), each
launch a PyTorch operator (`ops/library.py`).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.  It imports neither
JAX nor anything of the JAX package.
"""

__version__ = "0.1.0"

from . import (config, data, diffusion, models, nn, ops, parallel, serve,
               train, utils)
from .config import Algorithm, get_algorithm, set_algorithm
from .ops.coords import SparseGrid
from .tensor import (SparseTensor, TensorField, cat, cat_slice,
                     dense_coordinates, interpolate_at, slice_to_field,
                     sparse_tensor, stack_mean, stack_sum, stack_var,
                     to_sparse_dense)

__all__ = ["Algorithm", "get_algorithm", "set_algorithm", "config", "data", "diffusion", "models", "nn", "ops", "parallel",
           "serve", "train", "utils",
           "SparseGrid", "SparseTensor", "TensorField", "cat", "cat_slice",
           "dense_coordinates", "interpolate_at", "slice_to_field",
           "sparse_tensor", "stack_mean", "stack_sum", "stack_var",
           "to_sparse_dense", "__version__"]
