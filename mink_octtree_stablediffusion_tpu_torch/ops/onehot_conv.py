"""Sparse conv given a kernel map, as a hand-written CUDA kernel (B4).

Port of the ops-level half of `mink_octtree_stablediffusion_tpu/ops/
onehot_conv.py` (the fused conv, its other half, is ``ops/fused_conv.py``):

- ``onehot_sparse_conv`` replaces the TPU kernel **B4** of the same name:
  ``out_j = Σ_k f[nbr[k, j]] · W_k`` for a precomputed map
  ``nbr_idx int32[K, N_out]`` (-1 = missing), with bf16 operands by default
  and float32 accumulation, the output in the features' dtype.  On the card
  it launches ``csrc/onehot_sparse_conv.cu`` (a windowed gather-GEMM whose
  header states its design); on the CPU it takes its plain version.
- ``onehot_conv`` is the autograd Function for JAX's ``custom_vjp``
  ``onehot_conv``: forward B4, backward ``_xla_backward``, the JAX package's
  XLA formula (a masked gather, two einsums and an ``index_add_``) in plain
  PyTorch on both devices -- it is not a Pallas kernel there either.
  ``nbr_idx`` gets no gradient.
- ``use_onehot_conv`` / ``enabled``: the route flag ``nn/conv.py`` reads.
  ``False`` sends bounded-grid convs to ``kernel_map`` +
  ``sparse_conv_apply`` (route ``"plain"``), as in the JAX package.
  ``True`` and ``None`` (the default) keep the fused route (B1) on both
  devices: on the CPU that is B1's plain version, where JAX's ``None``
  takes the XLA gather route on its CPU backend; the two agree to 2e-5
  in float32 (`tests/test_torch_fused_conv.py`).

There is no fallback: a CUDA tensor launches the kernel or raises.  The
launch count is ``onehot_sparse_conv.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .conv import mm_f32
from .coords import SparseGrid

SOURCE = "onehot_sparse_conv.cu"

_ENABLED: bool | None = None  # None = the fused route (see the docstring)


def use_onehot_conv(flag: bool | None) -> None:
    """``False`` routes bounded-grid convs through ``kernel_map`` +
    ``sparse_conv_apply``; ``True`` or ``None`` through the fused kernel."""
    global _ENABLED
    _ENABLED = flag


def enabled(grid: SparseGrid | None = None) -> bool:
    flag = _ENABLED is not False
    if grid is not None:
        flag = flag and grid.extent is not None
    return flag


def map_conv_plain(features: torch.Tensor, kernel: torch.Tensor,
                   nbr_idx: torch.Tensor, compute_dtype) -> torch.Tensor:
    """B4's (and B7's) function in plain PyTorch: for each offset a masked
    row gather and a ``mm_f32`` in ``compute_dtype``, summed in float32; the
    output in the features' dtype.  Indices outside [0, N) read as
    missing, as in the kernels."""
    n = features.shape[0]
    f, w = features.to(compute_dtype), kernel.to(compute_dtype)
    out = torch.zeros((nbr_idx.shape[1], kernel.shape[2]),
                      dtype=torch.float32, device=features.device)
    for kk in range(nbr_idx.shape[0]):
        idx = nbr_idx[kk]
        hit = (idx >= 0) & (idx < n)
        rows = f[torch.where(hit, idx, 0).long()] * hit[:, None].to(f.dtype)
        out += mm_f32(rows, w[kk])
    return out.to(features.dtype)


def launch_map_conv(source: str, features: torch.Tensor,
                    kernel: torch.Tensor,
                    nbr_idx: torch.Tensor) -> tuple:
    """Check the operands, allocate the output in the features' dtype and
    launch ``csrc/<source>``'s ``<stem>_forward`` (B4 or B7, one C
    signature) on PyTorch's current stream.  Counts nothing: the wrappers
    do.  Returns the output and whether a kernel was launched."""
    from ..utils import cuda_build

    dev = features.device
    if features.dim() != 2 or kernel.dim() != 3 or nbr_idx.dim() != 2:
        raise ValueError("need features [N, Cin], kernel [K, Cin, Cout], "
                         "nbr_idx [K, N_out]")
    (n, cin), (k, kcin, cout), n_out = (features.shape, kernel.shape,
                                       nbr_idx.shape[1])
    if kcin != cin or nbr_idx.shape[0] != k:
        raise ValueError(f"features {tuple(features.shape)}, kernel "
                         f"{tuple(kernel.shape)} and nbr_idx "
                         f"{tuple(nbr_idx.shape)} disagree")
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"features: float32 or bfloat16, not "
                         f"{features.dtype}")
    for name, t, dt in (("features", features, features.dtype),
                        ("nbr_idx", nbr_idx, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if kernel.device != dev:
        raise ValueError(f"kernel on {kernel.device}, features on {dev}")
    out = torch.empty((n_out, cout), dtype=features.dtype, device=dev)
    if n_out == 0 or cout == 0:
        return out, False
    if cin == 0 or n == 0:
        return out.zero_(), False
    stem = source.rsplit(".", 1)[0]
    fn, err = cuda_build.bind(
        source, f"{stem}_forward",
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 +
        [ctypes.c_int] * 5 + [ctypes.c_void_p], f"{stem}_error_string")
    w = kernel.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(features.data_ptr(), int(features.dtype == torch.bfloat16),
                w.data_ptr(), nbr_idx.data_ptr(), out.data_ptr(), n, n_out,
                cin, cout, k, stream)
    if rc != 0:
        raise RuntimeError(f"{stem} launch failed: " + err(rc).decode())
    return out, True


def onehot_sparse_conv(features: torch.Tensor, kernel: torch.Tensor,
                       nbr_idx: torch.Tensor,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """B4: the conv of ``features`` [N, Cin] with ``kernel`` [K, Cin, Cout]
    along ``nbr_idx`` int32[K, N_out] → [N_out, Cout] in the features'
    dtype, with ``compute_dtype`` operands (bf16 by default, as in JAX) and
    float32 accumulation.  No gradient: use ``onehot_conv``.

    The JAX kernel's Mosaic parameters ``tile``, ``tw`` and ``interpret``
    are left out: the CUDA kernel's tile and window sizes are fixed in its
    source.  CUDA tensors launch the kernel (K ≤ 343), which computes in
    bf16 only (another ``compute_dtype`` raises); CPU tensors take the
    plain version in ``compute_dtype``."""
    if features.device.type == "cpu":
        return map_conv_plain(features, kernel, nbr_idx, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA one-hot conv computes in bfloat16, not {compute_dtype}")
    out, launched = launch_map_conv(SOURCE, features, kernel, nbr_idx)
    onehot_sparse_conv.launches += launched
    return out


onehot_sparse_conv.launches = 0


def _xla_backward(features: torch.Tensor, kernel: torch.Tensor,
                  nbr_idx: torch.Tensor, g: torch.Tensor):
    """(dF, dW) of the conv given a map, JAX's ``_xla_backward``: the
    forward's masked gather for ``dW = einsum("nkc,no->kco")``, and the
    cotangent through ``W_kᵀ`` scattered back with ``index_add_``."""
    k, n_out = nbr_idx.shape
    cin = features.shape[1]
    idx_t = nbr_idx.t()
    m = idx_t >= 0
    safe = torch.where(m, idx_t, 0).long()
    gathered = features[safe] * m[..., None].to(features.dtype)
    dkernel = torch.einsum("nkc,no->kco", gathered, g)
    gw = torch.einsum("no,kco->nkc", g, kernel) * m[..., None].to(g.dtype)
    dfeat = torch.zeros_like(features).index_add_(
        0, safe.reshape(-1), gw.reshape(n_out * k, cin).to(features.dtype))
    return dfeat, dkernel


class OnehotConv(torch.autograd.Function):
    """JAX's ``onehot_conv`` custom VJP: forward B4 at its default compute
    dtype, backward ``_xla_backward`` in plain PyTorch."""

    @staticmethod
    def forward(ctx, features, kernel, nbr_idx):
        ctx.save_for_backward(features, kernel, nbr_idx)
        return onehot_sparse_conv(features, kernel, nbr_idx)

    @staticmethod
    def backward(ctx, g):
        features, kernel, nbr_idx = ctx.saved_tensors
        df, dk = _xla_backward(features, kernel, nbr_idx, g.contiguous())
        return df, dk.to(kernel.dtype), None


def onehot_conv(features: torch.Tensor, kernel: torch.Tensor,
                nbr_idx: torch.Tensor) -> torch.Tensor:
    """B4, differentiable in ``features`` and ``kernel``."""
    return OnehotConv.apply(features, kernel, nbr_idx)
