"""Fused sparse conv: neighbour search + gather + GEMM in hand-written CUDA
kernels, forward and backward.

Replaces the TPU kernels of `mink_octtree_stablediffusion_tpu/ops/
onehot_conv.py` that ``fused_sparse_conv`` and its custom VJP
(``_fused_conv``) reach:

- **B1**, ``_fused_impl``: the forward, ``csrc/fused_sparse_conv.cu``;
- **B2**, ``_fused_impl`` in the flipped direction (``_FusedStatic.
  flipped``): dF, the same CUDA kernel on the weight cast transposed;
- **B3**, ``_dkernel_fused``: dW, ``csrc/fused_sparse_conv_dw.cu``;
- **B8/B9**, B1 cut into stages by the repository's attribution scripts
  (`scripts/bench_kernel_parts.py::variant_conv` on the room,
  `scripts/bench_parts_finest.py::variant` on the finest octree level):
  ``fused_conv_stage``, B1's kernel with a compile-time stage parameter.

Each source is CUDA C++ for ``sm_90a`` (bf16 tensor-core GEMM with float32
accumulation) whose header states what bounds it on the H100 and what its
design does about that.  B1's source casts its operands to bf16 once per
call in a pass before the conv (plain versions: ``pad_features``,
``pack_weight``; the padding follows the tile that ``tile_shape`` picks).
B3's source runs its passes from one call: the cast (``dw_operands``), one
search per (row, offset) compacted into a pair list (``pair_list``), the
GEMM over the pairs and, where the rows are split (``dw_splits``), an
ordered sum of the splits' partials (``_dkernel_pairs_plain``); its GEMM
tile is ``dw_tile_shape``'s.

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
``fused_conv_dkernel``, ``fused_conv_stage``) launches its kernel for CUDA tensors (or raises)
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
import functools
import math

import numpy as np
import torch

from .conv import default_compute_dtype, mm_f32
from .coords import SparseGrid, _cells, _tuplize, device_const
from .kernels import KernelSpec
from ..utils.device import stream_guard

SOURCE = "fused_sparse_conv.cu"  # B1, B2 and the stages (B8/B9)
DW_SOURCE = "fused_sparse_conv_dw.cu"  # B3
SOURCES = (SOURCE, DW_SOURCE)
MAX_K = 125  # offsets the kernels' geometry block holds (csrc MAX_K)
# B1's pipeline cut at a stage (csrc ``Stage``, in its order): ``full`` the
# conv, ``empty`` zeros, ``search`` the matches counted, ``gather`` the
# matched rows summed (see ``_stage_plain``)
STAGES = ("full", "empty", "search", "gather")
# B3's passes run up to a stage (csrc ``Stage``, in its order): ``full``
# dW, ``cast`` the bf16 operands, ``pairs`` the compacted pair list
DW_STAGES = ("full", "cast", "pairs")
DW_ROWS = 256  # output rows of B3's search and compaction blocks (csrc ROWS)
# B3's row splits: one per block where the tiles fill two blocks on each of
# the card's 132 SMs, else enough for four, at most DW_MAX_SPLITS, one a
# chunk of depth, and partials of at most DW_PARTIAL_BYTES
DW_FULL_BLOCKS, DW_TARGET_BLOCKS = 264, 528
DW_MAX_SPLITS, DW_PARTIAL_BYTES = 64, 16 << 20


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


def dw_tile_shape(cin: int, cout: int) -> tuple:
    """(BI, BO, BD) of B3's GEMM: the Cin and the Cout tile, each the
    smallest of 32 and 64 that holds the width, else 128, and the pairs of
    one ring stage, 128 for the 32 x 32 tile (whose 8 warps all split the
    depth), else 64."""
    def pick(c):
        return next((t for t in (32, 64) if c <= t), 128)
    bi, bo = pick(cin), pick(cout)
    return bi, bo, 128 if bi == bo == 32 else 64


def dw_splits(n_out: int, cin: int, cout: int, k: int) -> int:
    """The row splits S of B3's GEMM: 1 where its (Cin tile, Cout tile,
    offset) blocks reach ``DW_FULL_BLOCKS``, else enough splits for
    ``DW_TARGET_BLOCKS`` blocks, bounded by ``DW_MAX_SPLITS``, by one chunk
    of ``BD`` pairs a split at ``n_out`` pairs an offset, and by float32
    partials [S, K, Cin, Cout] of ``DW_PARTIAL_BYTES``."""
    bi, bo, bd = dw_tile_shape(cin, cout)
    blocks = -(-cin // bi) * -(-cout // bo) * k
    if blocks >= DW_FULL_BLOCKS:
        return 1
    return max(1, min(-(-DW_TARGET_BLOCKS // blocks), -(-n_out // bd),
                      DW_MAX_SPLITS, DW_PARTIAL_BYTES // (4 * k * cin * cout)))


def dw_operands(features: torch.Tensor, g: torch.Tensor) -> tuple:
    """B3's operands as its cast pass makes them once per call (this is
    that pass's plain version): ``pad_features`` of the features and of
    the cotangent, bf16 [N, C rounded up to 8], zero past C."""
    return pad_features(features), pad_features(g)


def pair_list(in_keys: torch.Tensor, out_coords: torch.Tensor,
              out_valid: torch.Tensor, offs: np.ndarray, s_in,
              cells) -> tuple:
    """B3's compacted pairs as its search and compaction passes make them
    (this is their plain version): (starts int32 [K + 1], pair_in int32
    [P], pair_out int32 [P]), offset k's matched (input row, output row)
    pairs at ``starts[k]:starts[k + 1]`` in ascending output row."""
    match = neighbor_index(in_keys, query_keys(out_coords, out_valid, offs,
                                               s_in, cells)).T
    hit = match >= 0
    starts = torch.zeros(match.shape[0] + 1, dtype=torch.int32,
                         device=match.device)
    starts[1:] = hit.sum(1).cumsum(0)
    return (starts, match[hit].to(torch.int32),
            hit.nonzero()[:, 1].to(torch.int32))


def _dkernel_pairs_plain(features: torch.Tensor, g: torch.Tensor,
                         starts: torch.Tensor, pair_in: torch.Tensor,
                         pair_out: torch.Tensor, splits: int, depth: int,
                         compute_dtype) -> torch.Tensor:
    """B3's GEMM and reduction in plain PyTorch: offset k's pairs cut into
    chunks of ``depth``, the chunks shared out to ``splits`` contiguous
    runs, each run's ``f[pair_in]ᵀ · g[pair_out]`` in float32 (a split with
    no pair gives zeros), and the splits summed in order → float32 [K, Cin,
    Cout]."""
    f, gg = features.to(compute_dtype), g.to(compute_dtype)
    k = starts.shape[0] - 1
    parts = torch.zeros((splits, k, f.shape[1], gg.shape[1]),
                        dtype=torch.float32, device=f.device)
    bounds = starts.tolist()
    for kk in range(k):
        beg, end = bounds[kk], bounds[kk + 1]
        chunks = -(-(end - beg) // depth)
        per = -(-chunks // splits)
        for s in range(splits):
            c0 = min(chunks, s * per)
            q0, q1 = beg + c0 * depth, min(end, beg + (c0 + per) * depth)
            if q1 > q0:
                parts[s, kk] = mm_f32(f[pair_in[q0:q1].long()].T,
                                      gg[pair_out[q0:q1].long()])
    out = parts[0]
    for s in range(1, splits):
        out = out + parts[s]
    return out


def _stage_plain(features: torch.Tensor, kernel: torch.Tensor,
                 in_keys: torch.Tensor, out_coords: torch.Tensor,
                 out_valid: torch.Tensor, offs: np.ndarray, s_in, cells,
                 compute_dtype, stage: str) -> torch.Tensor:
    """Each stage of ``fused_conv_stage`` in plain PyTorch, float32
    [N_out, Cout]: ``full`` B1's function; ``empty`` zeros; ``search``
    column 0 = the number of offsets matched for the row; ``gather``
    ``out[j, c] = Σ_k f[match_k(j), c]`` with the rows in the compute dtype,
    for ``c < min(Cin, Cout)``, else 0."""
    if stage == "full":
        return _fused_sparse_conv_plain(features, kernel, in_keys, out_coords,
                                        out_valid, offs, s_in, cells,
                                        compute_dtype)
    (n_out, _), cout = out_coords.shape, kernel.shape[2]
    out = torch.zeros((n_out, cout), dtype=torch.float32,
                      device=features.device)
    if stage == "search" and cout:
        match = neighbor_index(in_keys, query_keys(out_coords, out_valid,
                                                   offs, s_in, cells))
        out[:, 0] = (match >= 0).sum(1).float()
    elif stage == "gather":
        m = min(features.shape[1], cout)
        out[:, :m] = _gathered(features[:, :m], in_keys, out_coords,
                               out_valid, offs, s_in, cells,
                               compute_dtype).float().sum(1)
    return out


# -- CUDA launches ------------------------------------------------------------

# kernel entry → (source, its argtypes, error-string function): device
# pointers, ints, the three host int arrays of the geometry (offsets,
# strides, cells), ints, the stream (see each entry in csrc/)
_P, _I = ctypes.c_void_p, ctypes.c_int
_GEOM = [ctypes.POINTER(ctypes.c_int)] * 3
_ENTRIES = {
    "fused_sparse_conv_forward": (SOURCE, [_P] * 8 + [_I] * 5 + _GEOM
                                  + [_I] * 4 + [_P],
                                  "fused_sparse_conv_error_string"),
    "fused_sparse_conv_cast": (SOURCE, [_P] * 4 + [_I] * 7 + [_P],
                               "fused_sparse_conv_error_string"),
    "fused_sparse_conv_dkernel": (DW_SOURCE, [_P] * 14 + [_I] * 5 + _GEOM
                                  + [_I] * 4 + [_P],
                                  "fused_sparse_conv_dw_error_string"),
}


def _lib(entry: str):
    """(kernel entry, error-string function) of ``entry``, its source
    built and bound at first use."""
    from ..utils import cuda_build

    source, argtypes, err = _ENTRIES[entry]
    return cuda_build.bind(source, entry, argtypes, err)


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


_GEOMETRY_ARGS: dict = {}


def _geometry_args(offs, s_in, cells):
    """The geometry as the kernels' host arrays, made once per geometry."""
    key = (offs.tobytes(), tuple(s_in), tuple(cells))
    args = _GEOMETRY_ARGS.get(key)
    if args is None:
        k = offs.shape[0]
        c_int3 = ctypes.c_int * 3
        args = ((ctypes.c_int * (3 * k))(*offs.reshape(-1).tolist()),
                c_int3(*s_in), c_int3(*cells))
        if len(_GEOMETRY_ARGS) >= 1024:
            _GEOMETRY_ARGS.clear()
        _GEOMETRY_ARGS[key] = args
    return args


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def tile_shape(cin: int, cout: int) -> tuple:
    """(BN, BK) of the forward kernel's instantiation: the Cout tile (32,
    64 or 128) and the Cin chunk (16, 32 or 64), the smallest that hold
    Cout and the 8-padded Cin, up to 128 and 64."""
    bn = next((n for n in (32, 64) if cout <= n), 128)
    bk = next((k for k in (16, 32) if _round_up(cin, 8) <= k), 64)
    return bn, bk


def pad_features(features: torch.Tensor) -> torch.Tensor:
    """The forward kernel's features as its cast pass makes them once per
    call (this is that pass's plain version): bf16 [N, CinF], CinF = Cin
    rounded up to 8 (one 16-byte copy per 8 channels), the channels past
    Cin zero."""
    n, cin = features.shape
    cinf = _round_up(cin, 8)
    out = torch.zeros((n, cinf), dtype=torch.bfloat16,
                      device=features.device)
    out.narrow(1, 0, cin).copy_(features)
    return out


def pack_weight(kernel: torch.Tensor, transpose: bool, bn: int,
                bk: int) -> torch.Tensor:
    """The forward kernel's weight as its cast pass makes it once per call
    (this is that pass's plain version): bf16 [K, CinW, CoutP] with ``W =
    kernel`` ([K, Cin, Cout]) or, for dF (``transpose``), ``W = kernelᵀ``
    per offset (``kernel`` the forward's [K, Cout, Cin]), zero-padded to
    CinW = Cin rounded up to ``bk`` and CoutP = Cout rounded up to
    ``bn``."""
    w = kernel.transpose(1, 2) if transpose else kernel
    k, cin, cout = w.shape
    out = torch.zeros((k, _round_up(cin, bk), _round_up(cout, bn)),
                      dtype=torch.bfloat16, device=w.device)
    out.narrow(1, 0, cin).narrow(2, 0, cout).copy_(w)
    return out


def _cast_buffers(n_in: int, cin: int, cout: int, k: int, bn: int, bk: int,
                  dev) -> tuple:
    """Uninitialised bf16 buffers for the cast pass: the features [N_in,
    CinF] and the weight [K, CinW, CoutP] (see ``pad_features``,
    ``pack_weight``)."""
    return (torch.empty((n_in, _round_up(cin, 8)), dtype=torch.bfloat16,
                        device=dev),
            torch.empty((k, _round_up(cin, bk), _round_up(cout, bn)),
                        dtype=torch.bfloat16, device=dev))


def _launch_cast(features: torch.Tensor, kernel: torch.Tensor,
                 transpose: bool = False) -> tuple:
    """The cast pass alone on the card (B1's launch runs it itself): the
    bf16 features and weight that ``pad_features`` and ``pack_weight``
    define, for the card test that holds them equal."""
    dev = features.device
    k, cin, cout = kernel.shape
    if transpose:
        cin, cout = cout, cin
    bn, bk = tile_shape(cin, cout)
    fb, wp = _cast_buffers(features.shape[0], cin, cout, k, bn, bk, dev)
    fn, err = _lib("fused_sparse_conv_cast")
    stream, guard = stream_guard(dev)
    with guard:
        rc = fn(features.data_ptr(), kernel.data_ptr(), fb.data_ptr(),
                wp.data_ptr(), features.shape[0], cin, cout, k, bn, bk,
                int(transpose), stream)
    if rc != 0:
        raise RuntimeError("fused_sparse_conv_cast launch failed: " +
                           err(rc).decode())
    return fb, wp


def _launch(features: torch.Tensor, kernel: torch.Tensor,
            in_keys: torch.Tensor, out_coords: torch.Tensor,
            out_valid: torch.Tensor, offs: np.ndarray, s_in, cells,
            compute_dtype, transpose_weight: bool = False,
            stage: str = "full") -> torch.Tensor:
    """Check the operands, allocate the output and the bf16 operand
    buffers, and launch ``fused_sparse_conv.cu`` on PyTorch's current
    stream: its operand cast (``pad_features``, ``pack_weight``), then the
    conv (B1; B2 with ``transpose_weight``, where ``kernel`` is the
    forward's [K, Cout, Cin] weight, cast transposed; B8/B9 with ``stage``
    other than ``full``).  Counts nothing: the wrappers do."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} not in {STAGES}")
    if transpose_weight and stage != "full":
        raise ValueError("the cut stages take the forward's weight")
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
    bn, bk = tile_shape(cin, cout)
    fb, wp = _cast_buffers(features.shape[0], cin, cout, k, bn, bk, dev)
    fn, err = _lib("fused_sparse_conv_forward")
    stream, guard = stream_guard(dev)
    with guard:
        rc = fn(features.data_ptr(), kernel.data_ptr(), fb.data_ptr(),
                wp.data_ptr(), in_keys.data_ptr(), out_coords.data_ptr(),
                out_valid.data_ptr(), out.data_ptr(), features.shape[0],
                n_out, cin, cout, k, *_geometry_args(offs, s_in, cells), bn,
                bk, int(transpose_weight), STAGES.index(stage), stream)
    if rc != 0:
        raise RuntimeError("fused_sparse_conv_forward launch failed: "
                           + err(rc).decode())
    return out


_DW_BUFFERS = ("fb", "gb", "map", "cnt", "off", "pair_in", "pair_out",
               "partial")


@functools.lru_cache(maxsize=256)
def _dw_workspace(n_in: int, n_out: int, cin: int, cout: int, k: int,
                  splits: int) -> tuple:
    """(byte offset of each of B3's buffers, in ``_DW_BUFFERS``' order, in
    one workspace; its size): fb bf16 [N_in, CinF], gb bf16 [N_out, CoutF]
    (``dw_operands``), the match map [K, N_out], the counts [K, row
    blocks] and their prefix sums [K · row blocks + 1], the pair lists
    [K · N_out] each (int32), and the float32 partials [S, K, Cin, Cout]
    where S > 1; each 256-byte aligned."""
    rb = -(-n_out // DW_ROWS)
    sizes = (2 * n_in * _round_up(cin, 8), 2 * n_out * _round_up(cout, 8),
             4 * k * n_out, 4 * k * rb, 4 * (k * rb + 1), 4 * k * n_out,
             4 * k * n_out, 4 * splits * k * cin * cout if splits > 1 else 0)
    offsets, at = [], 0
    for n in sizes:
        offsets.append(at)
        at += _round_up(n, 256)
    return tuple(offsets), at


def _run_dkernel(features: torch.Tensor, g: torch.Tensor,
                 in_keys: torch.Tensor, out_coords: torch.Tensor,
                 out_valid: torch.Tensor, offs: np.ndarray, s_in, cells,
                 compute_dtype, dw: torch.Tensor | None,
                 stage: str) -> tuple:
    """Check the operands, allocate the workspace and launch
    ``fused_sparse_conv_dw.cu``'s passes up to ``stage`` on PyTorch's
    current stream, writing dW into ``dw`` (``full``).  Returns (workspace,
    its offsets, S), or None where an operand is empty (nothing
    launched)."""
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
    if 0 in (n_in, n_out, cin, cout):
        return None
    bi, bo, _ = dw_tile_shape(cin, cout)
    splits = dw_splits(n_out, cin, cout, k)
    offsets, size = _dw_workspace(n_in, n_out, cin, cout, k, splits)
    ws = torch.empty(size, dtype=torch.uint8, device=dev)
    base = ws.data_ptr()
    bufs = [base + o for o in offsets]
    if splits == 1:
        bufs[-1] = None
    fn, err = _lib("fused_sparse_conv_dkernel")
    stream, guard = stream_guard(dev)
    with guard:
        rc = fn(features.data_ptr(), g.data_ptr(), in_keys.data_ptr(),
                out_coords.data_ptr(), out_valid.data_ptr(),
                None if dw is None else dw.data_ptr(), *bufs, n_in, n_out,
                cin, cout, k, *_geometry_args(offs, s_in, cells), bi, bo,
                splits, DW_STAGES.index(stage), stream)
    if rc != 0:
        raise RuntimeError("fused_sparse_conv_dkernel launch failed: " +
                           err(rc).decode())
    return ws, offsets, splits


def _launch_dkernel(features: torch.Tensor, g: torch.Tensor,
                    in_keys: torch.Tensor, out_coords: torch.Tensor,
                    out_valid: torch.Tensor, offs: np.ndarray, s_in, cells,
                    compute_dtype) -> torch.Tensor:
    """Allocate the float32 [K, Cin, Cout] output and launch
    ``fused_sparse_conv_dw.cu`` (B3: cast, search, scan, compaction, GEMM
    and, with S > 1, the ordered reduction) on PyTorch's current stream.
    Counts nothing: the wrapper does."""
    out = torch.empty((offs.shape[0], features.shape[1], g.shape[1]),
                      dtype=torch.float32, device=features.device)
    if _run_dkernel(features, g, in_keys, out_coords, out_valid, offs, s_in,
                    cells, compute_dtype, out, "full") is None:
        out.zero_()
    return out


def _launch_dkernel_passes(features: torch.Tensor, g: torch.Tensor,
                           in_keys: torch.Tensor, out_coords: torch.Tensor,
                           out_valid: torch.Tensor, offs: np.ndarray, s_in,
                           cells, stage: str) -> tuple:
    """B3's passes alone on the card, for the card tests that hold them
    equal to their plain versions: ``cast`` gives (fb, gb) as
    ``dw_operands``; ``pairs`` (starts, pair_in, pair_out) as
    ``pair_list``."""
    if stage not in DW_STAGES[1:]:
        raise ValueError(f"stage {stage!r} not in {DW_STAGES[1:]}")
    ws, at, _ = _run_dkernel(features, g, in_keys, out_coords, out_valid,
                             offs, s_in, cells, torch.bfloat16, None, stage)
    (n_in, cin), (n_out, cout) = features.shape, g.shape

    def view(name, dtype, *shape):
        n = math.prod(shape) * dtype.itemsize
        return ws.narrow(0, at[_DW_BUFFERS.index(name)], n).view(
            dtype).view(shape)
    if stage == "cast":
        return (view("fb", torch.bfloat16, n_in, _round_up(cin, 8)),
                view("gb", torch.bfloat16, n_out, _round_up(cout, 8)))
    rb = -(-n_out // DW_ROWS)
    k = offs.shape[0]
    starts = view("off", torch.int32, k * rb + 1)[::rb].clone()
    n = int(starts[-1])
    return (starts, view("pair_in", torch.int32, k * n_out)[:n],
            view("pair_out", torch.int32, k * n_out)[:n])


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


def fused_conv_stage(features: torch.Tensor, kernel: torch.Tensor,
                     in_grid: SparseGrid, out_grid: SparseGrid,
                     spec: KernelSpec, stage: str = "full",
                     compute_dtype=None) -> torch.Tensor:
    """B1's forward cut at ``stage`` (one of ``STAGES``; see
    ``_stage_plain``), float32 [N_out, Cout], no gradient: the counterpart
    of the TPU attribution kernels B8 (`scripts/bench_kernel_parts.py`) and
    B9 (`scripts/bench_parts_finest.py`).  ``full`` launches B1's own
    kernel and gives B1's output bit for bit.  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if in_grid.extent is None:
        raise ValueError("fused conv requires a bounded grid")
    offs, s_in, cells = conv_geometry(in_grid, spec)
    cd = compute_dtype or default_compute_dtype(features.device)
    args = (features, kernel, in_grid.flat_keys(), out_grid.coords,
            out_grid.valid, offs, s_in, cells, cd)
    if features.device.type == "cpu":
        return _stage_plain(*args, stage)
    out = _launch(*args, stage=stage)
    if out.numel() and features.numel():
        fused_conv_stage.launches += 1
    return out


fused_sparse_conv.launches = 0
fused_conv_dfeatures.launches = 0
fused_conv_dkernel.launches = 0
fused_conv_stage.launches = 0
