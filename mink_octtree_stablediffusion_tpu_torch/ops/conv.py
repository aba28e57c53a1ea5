"""Generalized sparse convolution given a kernel map: gather → GEMM.

Port of `mink_octtree_stablediffusion_tpu/ops/conv.py`.  For every kernel
offset k the input features are gathered along the precomputed map and
multiplied by W_k; missing neighbours contribute zero.  Kernel layout is
(K, Cin, Cout).

Compute-dtype policy (`ops/conv.py:39-45` of the JAX package): float32 on
the CPU; on the card the conv GEMMs take bfloat16 operands with float32
accumulation, and features stay float32 between layers.
"""

from __future__ import annotations

import torch

# default fused gather-GEMM size cutoff
DEFAULT_FUSED_THRESHOLD = 1 << 21

# None = auto (bfloat16 on CUDA, float32 on the CPU)
_DEFAULT_COMPUTE_DTYPE = None


def set_default_compute_dtype(dtype) -> None:
    """Override the conv-family compute dtype globally (None = auto)."""
    global _DEFAULT_COMPUTE_DTYPE
    _DEFAULT_COMPUTE_DTYPE = dtype


def default_compute_dtype(device: torch.device) -> torch.dtype:
    if _DEFAULT_COMPUTE_DTYPE is not None:
        return _DEFAULT_COMPUTE_DTYPE
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with float32 accumulation and a float32 result (JAX's
    ``preferred_element_type=float32``): products of bfloat16 operands are
    exact in float32, so widening first is the same arithmetic."""
    return torch.matmul(a.float(), b.float())


def gather_rows(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features[idx] with -1 → zero row.  idx [M], features [N, C] → [M, C]."""
    m = idx >= 0
    return features[idx.clamp(min=0).long()] * m[:, None].to(features.dtype)


def sparse_conv_apply(features: torch.Tensor, kernel: torch.Tensor,
                      nbr_idx: torch.Tensor, bias: torch.Tensor | None = None,
                      fused_threshold: int | None = None,
                      compute_dtype=None) -> torch.Tensor:
    """Apply a sparse convolution given ``nbr_idx int32[K, N_out]``: one
    [N_out, K·Cin] x [K·Cin, Cout] GEMM when the gathered buffer is small,
    else K looped GEMMs."""
    if fused_threshold is None:
        fused_threshold = DEFAULT_FUSED_THRESHOLD
    k, n_out = nbr_idx.shape
    cin, cout = features.shape[1], kernel.shape[2]
    dtype = features.dtype
    cd = compute_dtype or dtype
    f = features.to(cd)
    kern = kernel.to(cd)
    if k * n_out * cin <= fused_threshold:
        idx_t = nbr_idx.t()  # [N_out, K]
        m = idx_t >= 0
        g = f[idx_t.clamp(min=0).long()] * m[..., None].to(cd)
        out = mm_f32(g.reshape(n_out, k * cin), kern.reshape(k * cin, cout))
    else:
        out = torch.zeros((n_out, cout), dtype=torch.float32,
                          device=features.device)
        for kk in range(k):
            out = out + mm_f32(gather_rows(f, nbr_idx[kk]), kern[kk])
    out = out.to(dtype)
    if bias is not None:
        out = out + bias.to(dtype)
    return out


def linear_apply(features: torch.Tensor, kernel: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel-volume-1 fast path: a plain matmul on the features."""
    w = kernel[0] if kernel.dim() == 3 else kernel
    out = features @ w.to(features.dtype)
    if bias is not None:
        out = out + bias.to(features.dtype)
    return out
