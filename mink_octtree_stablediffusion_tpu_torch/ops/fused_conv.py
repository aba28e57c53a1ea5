"""Fused sparse conv: neighbour search + gather + GEMM in hand-written CUDA
kernels, forward and backward.

Replaces the TPU kernels of `mink_octtree_stablediffusion_tpu/ops/
onehot_conv.py` that ``fused_sparse_conv`` and its custom VJP
(``_fused_conv``) reach:

- **B1**, ``_fused_impl``: the forward, ``csrc/fused_sparse_conv.cu``;
- **B2**, ``_fused_impl`` in the flipped direction (``_FusedStatic.
  flipped``): dF, the same CUDA kernel reading ``W_k`` transposed;
- **B3**, ``_dkernel_fused``: dW, ``csrc/fused_sparse_conv_dw.cu``.

Each source is CUDA C++ for ``sm_90a`` (bf16 tensor-core GEMM with float32
accumulation) whose header states what bounds it on the H100 and what its
design does about that.

For each output row j and offset k the query ``out_coord_j + delta_k`` must
lie on the input lattice, inside the extent, and row j must be valid; its
int32 flat key is then matched against the sorted input keys
(``flat_cell_key``) and ``out_j = sum_k f[match_k(j)] · W_k``.  One kernel
serves plain, strided, pinned-transpose and generative convs.  The
backward (``FusedSparseConv``) runs the same search in the transpose
direction for dF -- the grids swap roles, the offsets negate, the searched
lattice is the forward's output lattice -- and the forward's search for
``dW_k = sum_j f[match_k(j)]ᵀ · g_j``.  Coordinates, valid masks and keys
get no gradient; the bias add stays outside the Function, as in JAX.

Each wrapper (``fused_sparse_conv``, ``fused_conv_dfeatures``,
``fused_conv_dkernel``) launches its kernel for CUDA tensors (or raises)
and takes its plain PyTorch version only for tensors on the CPU: there is
no fallback.  Each counts its kernel launches in ``.launches``.  The
Mosaic mechanics of the TPU kernels (one-hot gather as a matmul, lane
padding, VMEM budgets, band schedules and the "over budget → XLA"
fallbacks of the forward and the backward) are not carried over: every
conv the JAX package would send to ``fused_sparse_conv`` goes to the
kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .conv import default_compute_dtype, mm_f32
from .coords import SparseGrid, _cells, _tuplize, device_const
from .kernels import KernelSpec

SOURCE = "fused_sparse_conv.cu"  # B1 and B2
DW_SOURCE = "fused_sparse_conv_dw.cu"  # B3
SOURCES = (SOURCE, DW_SOURCE)
MAX_K = 125  # offsets the kernels' geometry block holds (csrc MAX_K)


def conv_geometry(in_grid: SparseGrid, spec: KernelSpec):
    """(offsets [K, D] with the transpose sign applied, input stride,
    input cells per axis) of a bounded-grid conv."""
    offs = spec.absolute_offsets(in_grid.stride)
    if spec.transpose:
        offs = -offs
    s_in = _tuplize(in_grid.stride, in_grid.ndim)
    return offs.astype(np.int32), s_in, _cells(in_grid.extent, s_in)


def flipped_geometry(out_grid: SparseGrid, offs: np.ndarray):
    """Geometry of the transpose direction (dF): the offsets negate and the
    searched lattice is the forward's output lattice."""
    s_out = _tuplize(out_grid.stride, out_grid.ndim)
    return -offs, s_out, _cells(out_grid.extent, s_out)


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


def neighbor_index(in_keys: torch.Tensor, qk: torch.Tensor) -> torch.Tensor:
    """Input row matching each query key (-1 for none): lower bound in the
    sorted keys, then an equality check."""
    n = in_keys.shape[0]
    pos = torch.searchsorted(in_keys, qk.reshape(-1), out_int32=True
                             ).reshape(qk.shape)
    hit = (qk >= 0) & (pos < n) & (
        in_keys[pos.clamp(max=n - 1).long()] == qk)
    return torch.where(hit, pos, -1)


def _gathered(features, in_keys, out_coords, out_valid, offs, s_in, cells,
              compute_dtype) -> torch.Tensor:
    """[N_out, K, Cin]: each output row's matched input rows in the compute
    dtype, zero on a miss."""
    match = neighbor_index(in_keys, query_keys(out_coords, out_valid, offs,
                                               s_in, cells))
    f = features.to(compute_dtype)
    return f[match.clamp(min=0).long()] * (match >= 0)[..., None].to(f.dtype)


def _fused_sparse_conv_plain(features: torch.Tensor, kernel: torch.Tensor,
                             in_keys: torch.Tensor, out_coords: torch.Tensor,
                             out_valid: torch.Tensor, offs: np.ndarray, s_in,
                             cells, compute_dtype) -> torch.Tensor:
    """B1's (and, on the flipped operands, B2's) function in plain
    PyTorch: query keys, a ``searchsorted`` on the input keys, a gather,
    then one matmul with float32 accumulation."""
    n_out, k = out_coords.shape[0], offs.shape[0]
    cin, cout = kernel.shape[1], kernel.shape[2]
    g = _gathered(features, in_keys, out_coords, out_valid, offs, s_in,
                  cells, compute_dtype)
    out = mm_f32(g.reshape(n_out, k * cin),
                 kernel.to(compute_dtype).reshape(k * cin, cout))
    return out.to(features.dtype)


def _dkernel_plain(features: torch.Tensor, g: torch.Tensor,
                   in_keys: torch.Tensor, out_coords: torch.Tensor,
                   out_valid: torch.Tensor, offs: np.ndarray, s_in, cells,
                   compute_dtype) -> torch.Tensor:
    """B3's function in plain PyTorch (JAX ``_dkernel_gather``): the
    forward's matches, a gather, and ``einsum("nkc,no->kco")`` as one
    batched matmul with float32 accumulation → float32 [K, Cin, Cout]."""
    a = _gathered(features, in_keys, out_coords, out_valid, offs, s_in,
                  cells, compute_dtype)
    return mm_f32(a.permute(1, 2, 0), g.to(compute_dtype))


# -- CUDA launches ------------------------------------------------------------

# source → (kernel entry, its argtypes, error-string function): six device
# pointers, five ints, three host int arrays (offsets, strides, cells),
# the forward's transpose_weight flag, the stream
_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 +
         [ctypes.POINTER(ctypes.c_int)] * 3)
_ENTRIES = {
    SOURCE: ("fused_sparse_conv_forward",
             _ARGS + [ctypes.c_int, ctypes.c_void_p],
             "fused_sparse_conv_error_string"),
    DW_SOURCE: ("fused_sparse_conv_dkernel", _ARGS + [ctypes.c_void_p],
                "fused_sparse_conv_dw_error_string"),
}


def _lib(source: str):
    """(kernel entry, error-string function) of ``csrc/<source>``, built
    and bound at first use."""
    from ..utils import cuda_build

    return cuda_build.bind(source, *_ENTRIES[source])


def _check_operands(dev, compute_dtype, offs, k, *named):
    if compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA fused conv computes in bfloat16, not {compute_dtype}")
    if offs.shape[1] != 3:
        raise NotImplementedError("the CUDA fused conv takes 3-D grids")
    if not 1 <= k <= MAX_K or offs.shape[0] != k:
        raise ValueError(f"kernel volume {k} (offsets {offs.shape[0]}) "
                         f"outside 1..{MAX_K}")
    for name, t, dt in named:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")


def _geometry_args(offs, s_in, cells):
    k = offs.shape[0]
    c_int3 = ctypes.c_int * 3
    return ((ctypes.c_int * (3 * k))(*offs.reshape(-1).tolist()),
            c_int3(*s_in), c_int3(*cells))


def _launch(features: torch.Tensor, kernel: torch.Tensor,
            in_keys: torch.Tensor, out_coords: torch.Tensor,
            out_valid: torch.Tensor, offs: np.ndarray, s_in, cells,
            compute_dtype, transpose_weight: bool = False) -> torch.Tensor:
    """Check the operands, allocate the output and launch
    ``fused_sparse_conv.cu`` on PyTorch's current stream (B1; B2 with
    ``transpose_weight``, where ``kernel`` is the forward's [K, Cout, Cin]
    weight read as [K, Cin, Cout]).  Counts nothing: the wrappers do."""
    dev = features.device
    if transpose_weight:
        k, cout, cin = kernel.shape
    else:
        k, cin, cout = kernel.shape
    n_out = out_coords.shape[0]
    _check_operands(dev, compute_dtype, offs, k,
                    ("features", features, torch.float32),
                    ("kernel", kernel, torch.float32),
                    ("in_keys", in_keys, torch.int32),
                    ("out_coords", out_coords, torch.int32),
                    ("out_valid", out_valid, torch.bool))
    if features.shape[1] != cin or in_keys.shape[0] != features.shape[0]:
        raise ValueError("features/kernel/in_keys shapes disagree")
    out = torch.empty((n_out, cout), dtype=torch.float32, device=dev)
    if n_out == 0 or cout == 0:
        return out
    if cin == 0 or features.shape[0] == 0:
        return out.zero_()
    fn, err = _lib(SOURCE)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(features.data_ptr(), kernel.data_ptr(), in_keys.data_ptr(),
                out_coords.data_ptr(), out_valid.data_ptr(), out.data_ptr(),
                features.shape[0], n_out, cin, cout, k,
                *_geometry_args(offs, s_in, cells), int(transpose_weight),
                stream)
    if rc != 0:
        raise RuntimeError("fused_sparse_conv launch failed: " +
                           err(rc).decode())
    return out


def _launch_dkernel(features: torch.Tensor, g: torch.Tensor,
                    in_keys: torch.Tensor, out_coords: torch.Tensor,
                    out_valid: torch.Tensor, offs: np.ndarray, s_in, cells,
                    compute_dtype) -> torch.Tensor:
    """Check the operands, allocate the zeroed float32 [K, Cin, Cout]
    output and launch ``fused_sparse_conv_dw.cu`` (B3) on PyTorch's current
    stream.  Counts nothing: the wrapper does."""
    dev = features.device
    k = offs.shape[0]
    (n_in, cin), (n_out, cout) = features.shape, g.shape
    _check_operands(dev, compute_dtype, offs, k,
                    ("features", features, torch.float32),
                    ("g", g, torch.float32),
                    ("in_keys", in_keys, torch.int32),
                    ("out_coords", out_coords, torch.int32),
                    ("out_valid", out_valid, torch.bool))
    if in_keys.shape[0] != n_in or out_coords.shape[0] != n_out:
        raise ValueError("features/g/keys/coords shapes disagree")
    out = torch.zeros((k, cin, cout), dtype=torch.float32, device=dev)
    if 0 in (n_in, n_out, cin, cout):
        return out
    fn, err = _lib(DW_SOURCE)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(features.data_ptr(), g.data_ptr(), in_keys.data_ptr(),
                out_coords.data_ptr(), out_valid.data_ptr(), out.data_ptr(),
                n_in, n_out, cin, cout, k,
                *_geometry_args(offs, s_in, cells), stream)
    if rc != 0:
        raise RuntimeError("fused_sparse_conv_dkernel launch failed: " +
                           err(rc).decode())
    return out


# -- the three wrappers and the autograd Function ---------------------------


def fused_conv_dfeatures(g: torch.Tensor, kernel: torch.Tensor,
                         in_grid: SparseGrid, out_grid: SparseGrid,
                         offs: np.ndarray, compute_dtype) -> torch.Tensor:
    """B2: dF [N_in, Cin] of the conv with offsets ``offs`` from ``in_grid``
    onto ``out_grid``, given the cotangent ``g`` [N_out, Cout] -- the
    transpose-direction conv of ``g`` with ``W_kᵀ``."""
    f_offs, s_out, cells = flipped_geometry(out_grid, offs)
    args = (g, out_grid.flat_keys(), in_grid.coords, in_grid.valid, f_offs,
            s_out, cells, compute_dtype)
    if g.device.type == "cpu":
        return _fused_sparse_conv_plain(args[0], kernel.transpose(1, 2),
                                        *args[1:])
    out = _launch(args[0], kernel, *args[1:], transpose_weight=True)
    if out.numel() and g.numel():  # an empty conv launches nothing
        fused_conv_dfeatures.launches += 1
    return out


def fused_conv_dkernel(features: torch.Tensor, g: torch.Tensor,
                       in_grid: SparseGrid, out_grid: SparseGrid,
                       offs: np.ndarray, s_in, cells,
                       compute_dtype) -> torch.Tensor:
    """B3: dW float32 [K, Cin, Cout] of the conv, given its input
    ``features`` and the cotangent ``g``."""
    args = (features, g, in_grid.flat_keys(), out_grid.coords,
            out_grid.valid, offs, s_in, cells, compute_dtype)
    if features.device.type == "cpu":
        return _dkernel_plain(*args)
    out = _launch_dkernel(*args)
    if features.numel() and g.numel():
        fused_conv_dkernel.launches += 1
    return out


class FusedSparseConv(torch.autograd.Function):
    """The fused conv with its backward as kernels: forward B1, dF B2, dW
    B3 (JAX ``_fused_conv``'s custom VJP).  On the CPU each direction is
    its plain version, so the CPU tests cover the backward formulas
    themselves, not autograd of the plain forward."""

    @staticmethod
    def forward(ctx, features, kernel, in_grid, out_grid, offs, s_in, cells,
                compute_dtype):
        ctx.save_for_backward(features, kernel)
        ctx.geometry = (in_grid, out_grid, offs, s_in, cells, compute_dtype)
        args = (features, kernel, in_grid.flat_keys(), out_grid.coords,
                out_grid.valid, offs, s_in, cells, compute_dtype)
        if features.device.type == "cpu":
            return _fused_sparse_conv_plain(*args)
        out = _launch(*args)
        if out.numel() and features.numel():
            fused_sparse_conv.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        features, kernel = ctx.saved_tensors
        in_grid, out_grid, offs, s_in, cells, cd = ctx.geometry
        g = g.contiguous()
        df = dk = None
        if ctx.needs_input_grad[0]:
            df = fused_conv_dfeatures(g, kernel, in_grid, out_grid, offs, cd)
        if ctx.needs_input_grad[1]:
            dk = fused_conv_dkernel(features, g, in_grid, out_grid, offs,
                                    s_in, cells, cd).to(kernel.dtype)
        return df, dk, None, None, None, None, None, None


def fused_sparse_conv(features: torch.Tensor, kernel: torch.Tensor,
                      in_grid: SparseGrid, out_grid: SparseGrid,
                      spec: KernelSpec, bias: torch.Tensor | None = None,
                      compute_dtype=None) -> torch.Tensor:
    """Sparse conv of ``features`` [N_in, Cin] (rows in ``in_grid``'s
    canonical flat-key order) with ``kernel`` [K, Cin, Cout] onto
    ``out_grid``, differentiable in ``features``, ``kernel`` and ``bias``.
    CUDA tensors launch the kernels; CPU tensors take the plain versions."""
    if in_grid.extent is None:
        raise ValueError("fused conv requires a bounded grid")
    offs, s_in, cells = conv_geometry(in_grid, spec)
    cd = compute_dtype or default_compute_dtype(features.device)
    out = FusedSparseConv.apply(features, kernel, in_grid, out_grid, offs,
                                s_in, cells, cd)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


fused_sparse_conv.launches = 0
fused_conv_dfeatures.launches = 0
fused_conv_dkernel.launches = 0
