"""Fused sparse conv: neighbour search + gather + GEMM in one CUDA kernel.

Replaces the TPU kernel `mink_octtree_stablediffusion_tpu/ops/onehot_conv.py
::_fused_impl` (its ``pallas_call``), reached there through
``fused_sparse_conv``.  The hand-written kernel is
``csrc/fused_sparse_conv.cu`` (CUDA C++ for ``sm_90a``, bf16 tensor-core
GEMM with fp32 accumulation); its header states what bounds it on the H100
(the bytes it must move, at the main path's widths) and what its design
does about that.

For each output row j and offset k the query ``out_coord_j + delta_k`` must
lie on the input lattice, inside the extent, and row j must be valid; its
int32 flat key is then matched against the sorted input keys
(``flat_cell_key``) and ``out_j = sum_k f[match_k(j)] · W_k``.  One kernel
serves plain, strided, pinned-transpose and generative convs.

``fused_sparse_conv`` launches the kernel for CUDA tensors (or raises) and
takes the plain PyTorch version ``_fused_sparse_conv_plain`` only for
tensors on the CPU: there is no fallback.  ``fused_sparse_conv.launches``
counts kernel launches.  The Mosaic mechanics of the TPU kernel (one-hot
gather as a matmul, lane padding, VMEM budgets, band schedules and the
"over budget → XLA" fallback) are not carried over: every conv the JAX
package would send to ``fused_sparse_conv`` goes to the kernel.  The bias
add stays outside the kernel, as in JAX.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .conv import default_compute_dtype, mm_f32
from .coords import SparseGrid, _cells, _tuplize, device_const
from .kernels import KernelSpec

SOURCE = "fused_sparse_conv.cu"
MAX_K = 125  # offsets the kernel's geometry block holds (csrc MAX_K)


def conv_geometry(in_grid: SparseGrid, spec: KernelSpec):
    """(offsets [K, D] with the transpose sign applied, input stride,
    input cells per axis) of a bounded-grid conv."""
    offs = spec.absolute_offsets(in_grid.stride)
    if spec.transpose:
        offs = -offs
    s_in = _tuplize(in_grid.stride, in_grid.ndim)
    return offs.astype(np.int32), s_in, _cells(in_grid.extent, s_in)


def query_keys(out_coords: torch.Tensor, out_valid: torch.Tensor,
               offs: np.ndarray, s_in, cells) -> torch.Tensor:
    """int32[N_out, K] flat key of ``out_coord + delta_k`` on the input
    lattice; -1 where the query is off the lattice, outside the extent or
    on an invalid row."""
    q = out_coords[:, None, 1:] + device_const(offs, torch.int32,
                                               out_coords.device)[None]
    key = out_coords[:, :1].expand(-1, offs.shape[0])
    ok = out_valid[:, None].expand(-1, offs.shape[0])
    for i, (s, c) in enumerate(zip(s_in, cells)):
        pos = torch.div(q[..., i], s, rounding_mode="floor")
        ok = ok & (q[..., i] == pos * s) & (pos >= 0) & (pos < c)
        key = key * c + pos
    return key.masked_fill(~ok, -1).to(torch.int32)


def _fused_sparse_conv_plain(features: torch.Tensor, kernel: torch.Tensor,
                             in_keys: torch.Tensor, out_coords: torch.Tensor,
                             out_valid: torch.Tensor, offs: np.ndarray, s_in,
                             cells, compute_dtype) -> torch.Tensor:
    """The kernel's function in plain PyTorch: query keys, a
    ``searchsorted`` on the input keys, a gather, then one matmul with
    float32 accumulation."""
    n_out, k = out_coords.shape[0], offs.shape[0]
    cin, cout = kernel.shape[1], kernel.shape[2]
    match = neighbor_index(in_keys, query_keys(out_coords, out_valid, offs,
                                               s_in, cells))
    f = features.to(compute_dtype)
    g = f[match.clamp(min=0).long()] * (match >= 0)[..., None].to(f.dtype)
    out = mm_f32(g.reshape(n_out, k * cin),
                 kernel.to(compute_dtype).reshape(k * cin, cout))
    return out.to(features.dtype)


def neighbor_index(in_keys: torch.Tensor, qk: torch.Tensor) -> torch.Tensor:
    """Input row matching each query key (-1 for none): lower bound in the
    sorted keys, then an equality check."""
    n = in_keys.shape[0]
    pos = torch.searchsorted(in_keys, qk.reshape(-1), out_int32=True
                             ).reshape(qk.shape)
    hit = (qk >= 0) & (pos < n) & (
        in_keys[pos.clamp(max=n - 1).long()] == qk)
    return torch.where(hit, pos, -1)


_bound_lib = None


def _lib():
    global _bound_lib
    if _bound_lib is None:
        from ..utils import cuda_build

        lib = cuda_build.load(SOURCE)
        fn = lib.fused_sparse_conv_forward
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 +
                       [ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_sparse_conv_error_string.argtypes = [ctypes.c_int]
        lib.fused_sparse_conv_error_string.restype = ctypes.c_char_p
        _bound_lib = lib
    return _bound_lib


def _launch(features: torch.Tensor, kernel: torch.Tensor,
            in_keys: torch.Tensor, out_coords: torch.Tensor,
            out_valid: torch.Tensor, offs: np.ndarray, s_in, cells,
            compute_dtype) -> torch.Tensor:
    """Check the operands, allocate the output and launch the kernel on
    PyTorch's current stream."""
    dev = features.device
    if compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA fused conv computes in bfloat16, not {compute_dtype}")
    if offs.shape[1] != 3:
        raise NotImplementedError("the CUDA fused conv takes 3-D grids")
    k, cin, cout = kernel.shape
    n_out = out_coords.shape[0]
    if not 1 <= k <= MAX_K or offs.shape[0] != k:
        raise ValueError(f"kernel volume {k} (offsets {offs.shape[0]}) "
                         f"outside 1..{MAX_K}")
    for name, t, dt in (("features", features, torch.float32),
                        ("kernel", kernel, torch.float32),
                        ("in_keys", in_keys, torch.int32),
                        ("out_coords", out_coords, torch.int32),
                        ("out_valid", out_valid, torch.bool)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if features.shape[1] != cin or in_keys.shape[0] != features.shape[0]:
        raise ValueError("features/kernel/in_keys shapes disagree")
    out = torch.empty((n_out, cout), dtype=torch.float32, device=dev)
    if n_out == 0 or cout == 0:
        return out
    if cin == 0 or features.shape[0] == 0:
        return out.zero_()
    c_int3 = ctypes.c_int * 3
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_sparse_conv_forward(
            features.data_ptr(), kernel.data_ptr(), in_keys.data_ptr(),
            out_coords.data_ptr(), out_valid.data_ptr(), out.data_ptr(),
            features.shape[0], n_out, cin, cout, k,
            (ctypes.c_int * (3 * k))(*offs.reshape(-1).tolist()),
            c_int3(*s_in), c_int3(*cells), stream)
    if rc != 0:
        raise RuntimeError("fused_sparse_conv launch failed: " +
                           lib.fused_sparse_conv_error_string(rc).decode())
    fused_sparse_conv.launches += 1
    return out


def fused_sparse_conv(features: torch.Tensor, kernel: torch.Tensor,
                      in_grid: SparseGrid, out_grid: SparseGrid,
                      spec: KernelSpec, bias: torch.Tensor | None = None,
                      compute_dtype=None) -> torch.Tensor:
    """Sparse conv of ``features`` [N_in, Cin] (rows in ``in_grid``'s
    canonical flat-key order) with ``kernel`` [K, Cin, Cout] onto
    ``out_grid``.  CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if in_grid.extent is None:
        raise ValueError("fused conv requires a bounded grid")
    offs, s_in, cells = conv_geometry(in_grid, spec)
    cd = compute_dtype or default_compute_dtype(features.device)
    args = (features, kernel, in_grid.flat_keys(), out_grid.coords,
            out_grid.valid, offs, s_in, cells, cd)
    if features.device.type == "cpu":
        out = _fused_sparse_conv_plain(*args)
    else:
        out = _launch(*args)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


fused_sparse_conv.launches = 0
