"""Sparse conv given a kernel map with float32-accurate products, as a
hand-written CUDA kernel (B7).

Port of `mink_octtree_stablediffusion_tpu/ops/pallas_conv.py`:
``pallas_sparse_conv`` replaces the TPU kernel **B7** of the same name,
the same function as B4 (``out_j = Σ_k f[nbr[k, j]] · W_k``, -1 = missing)
with the products the JAX kernel forms: the gathered rows in the features'
dtype times the kernel as given (float32), summed in float32, the output in
the features' dtype (bf16 features meet a float32 weight: only the output
is rounded).  Through its operator (``ops/library.py``), on the card it
launches ``csrc/pallas_sparse_conv.cu``
(``csrc/map_conv.cuh``'s design, shared with B4, with float32-accurate
products from bf16 split terms on the tensor cores); on the CPU it takes
its plain version, ``map_conv_plain`` in float32.  There is no
fallback: a CUDA tensor launches the kernel or raises.  The JAX docstring's
"automatic fallback to the XLA path on lowering failure" is not carried
over (the JAX code has none either).

JAX's ``use_pallas_conv`` / ``enabled`` flag is left out: nothing in
either package reads it.  The launch count is
``pallas_sparse_conv.launches``.
"""

from __future__ import annotations

import torch

from .onehot_conv import SOURCES

SOURCE = SOURCES[1]


def pallas_sparse_conv(features: torch.Tensor, kernel: torch.Tensor,
                       nbr_idx: torch.Tensor, tile: int = 256) -> torch.Tensor:
    """B7: the conv of ``features`` [N, Cin] (float32 or bfloat16) with
    ``kernel`` [K, Cin, Cout] along ``nbr_idx`` int32[K, N_out] → [N_out,
    Cout], in the features' dtype, the products float32-accurate.
    ``N_out`` must be a multiple of ``tile`` (JAX asserts it; here it
    raises ``ValueError``); the tile is otherwise a Mosaic parameter and
    ignored, and JAX's ``interpret`` is left out."""
    if nbr_idx.shape[1] % tile:
        raise ValueError("pad N_out to a multiple of the tile size")
    return torch.ops.mink_torch.pallas_sparse_conv(features, kernel, nbr_idx)


# launches of the kernel, counted by its operator's CUDA implementation
pallas_sparse_conv.launches = 0
