"""Sparse conv given a kernel map, as a hand-written CUDA kernel (B4).

Port of the ops-level half of `mink_octtree_stablediffusion_tpu/ops/
onehot_conv.py` (the fused conv, its other half, is ``ops/fused_conv.py``):

- ``onehot_sparse_conv`` replaces the TPU kernel **B4** of the same name:
  ``out_j = Σ_k f[nbr[k, j]] · W_k`` for a precomputed map
  ``nbr_idx int32[K, N_out]`` (-1 = missing), with bf16 operands by default
  and float32 accumulation, the output in the features' dtype.  On the card
  it launches ``csrc/onehot_sparse_conv.cu``; at float32 compute, where its
  function is B7's (float32 products, the output in the features' dtype),
  it launches B7's float32-accurate split-term instantiation,
  ``csrc/pallas_sparse_conv.cu``.  On the CPU it takes its plain version
  ``map_conv_plain``.
- B4 and B7 (``ops/pallas_conv.py``) share one CUDA design,
  ``csrc/map_conv.cuh`` (its header states it), launched by
  ``launch_map_conv``: a cast pass into bf16 terms (``split_terms``,
  ``map_conv_operands``), per-offset pair lists from the map
  (``map_pair_list``), a GEMM over exactly the matched pairs into float32
  partials, and a sum of each row's partials in offset order
  (``_map_conv_pairs_plain``); its tile is ``tile_shape``'s, its
  offset groups ``map_groups``'.
- ``onehot_conv`` is JAX's ``custom_vjp`` ``onehot_conv``: forward B4,
  backward ``_xla_backward``, the JAX package's XLA formula (a masked
  gather, two einsums and an ``index_add_``) in plain PyTorch on both
  devices -- it is not a Pallas kernel there either -- registered as the
  autograd formula of B4's operator (``ops/library.py``).  ``nbr_idx``
  gets no gradient.
- ``use_onehot_conv`` / ``enabled``: the route flag ``nn/conv.py`` reads.
  ``False`` sends bounded-grid convs to ``kernel_map`` +
  ``sparse_conv_apply`` (route ``"plain"``), as in the JAX package.
  ``True`` and ``None`` (the default) keep the fused route (B1) on both
  devices: on the CPU that is B1's plain version, where JAX's ``None``
  takes the XLA gather route on its CPU backend; the two agree to 2e-5
  in float32 (`tests/test_torch_fused_conv.py`).

There is no fallback: a CUDA tensor launches the kernel (through the
operator's CUDA implementation) or raises.  The launch count is
``onehot_sparse_conv.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .conv import mm_f32
from .coords import SparseGrid
from .fused_conv import _round_up, split_terms, tile_shape
from ..utils.device import stream_guard

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


# -- the kernel's passes (csrc/map_conv.cuh), their plain versions ---------

SOURCES = (SOURCE, "pallas_sparse_conv.cu")  # B4, B7
# bf16 terms (features, weight) of each source's products, by the features'
# dtype: B4 rounds both operands to bf16; B7 keeps the fp32 weight (three
# terms) and fp32 features (three terms), bf16 features being exact in one
MAP_TERMS = {SOURCES[0]: {torch.float32: (1, 1), torch.bfloat16: (1, 1)},
             SOURCES[1]: {torch.float32: (3, 3), torch.bfloat16: (1, 3)}}
# the kernel's passes run up to a stage (csrc ``Stage``, in its order):
# ``full`` the conv, ``cast`` the bf16 terms, ``pairs`` the pair lists
MAP_STAGES = ("full", "cast", "pairs")
MAP_ROWS = 256  # output rows of a count or compaction block (csrc ROWS)
MAP_MAX_K = 65535  # offsets (the grids' y dimension)
MAP_PARTIAL_BYTES = 1 << 30  # the GEMM's fp32 partials, at most




def map_groups(n_out: int, cout: int, k: int) -> int:
    """Offsets per GEMM launch: each offset has at most ``n_out`` pairs,
    and a group's float32 partials [G · N_out, Cout] stay within
    ``MAP_PARTIAL_BYTES`` (at least one offset)."""
    return max(1, min(k, MAP_PARTIAL_BYTES // max(1, 4 * n_out * cout)))


def map_conv_operands(features: torch.Tensor, kernel: torch.Tensor,
                      terms: tuple, bn: int, bk: int) -> tuple:
    """The operands as the cast pass makes them once per call (this is its
    plain version): the features' ``split_terms`` bf16 [TA, N, CinF] and
    the weight's [TB, K, CinW, CoutP], zero-padded to CinF = Cin rounded up
    to 8, CinW to ``bk`` and CoutP to ``bn``."""
    (n, cin), (k, _, cout) = features.shape, kernel.shape
    fb = torch.zeros((terms[0], n, _round_up(cin, 8)), dtype=torch.bfloat16,
                     device=features.device)
    fb[:, :, :cin] = split_terms(features, terms[0])
    wb = torch.zeros((terms[1], k, _round_up(cin, bk), _round_up(cout, bn)),
                     dtype=torch.bfloat16, device=kernel.device)
    wb[:, :, :cin, :cout] = split_terms(kernel, terms[1])
    return fb, wb


def map_pair_list(nbr_idx: torch.Tensor, n_in: int) -> tuple:
    """The pair lists as the count, scan and compaction passes make them
    (this is their plain version): (starts int32 [K + 1], pair_in int32
    [P], pos int32 [K, N_out]): offset k's pairs ``q`` in
    ``starts[k]:starts[k + 1]``, in ascending output row ``j``, with
    ``pair_in[q] = nbr[k, j]`` and ``pos[k, j] = q`` (-1 where ``nbr[k, j]``
    lies outside [0, ``n_in``))."""
    hit = (nbr_idx >= 0) & (nbr_idx < n_in)
    starts = torch.zeros(nbr_idx.shape[0] + 1, dtype=torch.int32,
                         device=nbr_idx.device)
    starts[1:] = hit.sum(1).cumsum(0)
    pos = torch.full(nbr_idx.shape, -1, dtype=torch.int32,
                     device=nbr_idx.device)
    pos[hit] = torch.arange(int(hit.sum()), dtype=torch.int32,
                            device=nbr_idx.device)
    return starts, nbr_idx[hit].to(torch.int32), pos


def _map_conv_pairs_plain(features: torch.Tensor, kernel: torch.Tensor,
                          nbr_idx: torch.Tensor, terms: tuple,
                          group: int) -> torch.Tensor:
    """The GEMM and the reduce in plain PyTorch, in the kernel's order:
    each pair's float32 partial ``Σ_{a + b ≤ 2} fterm_a[pair_in] ·
    wterm_b[k]``, then every output row's partials added offset by offset
    to a float32 sum, ``group`` offsets at a time → the features'
    dtype."""
    bn, bk = tile_shape(features.shape[1], kernel.shape[2], terms)
    fb, wb = map_conv_operands(features, kernel, terms, bn, bk)
    cin, cout = features.shape[1], kernel.shape[2]
    fb, wb = fb[..., :cin].float(), wb[:, :, :cin, :cout].float()
    starts, pair_in, pos = map_pair_list(nbr_idx, features.shape[0])
    k, n_out = nbr_idx.shape
    part = torch.zeros((pair_in.shape[0], cout), dtype=torch.float32,
                       device=features.device)
    for kk in range(k):
        q0, q1 = int(starts[kk]), int(starts[kk + 1])
        rows = pair_in[q0:q1].long()
        for a in range(terms[0]):
            for b in range(terms[1]):
                if a + b <= 2:
                    part[q0:q1] += fb[a][rows] @ wb[b, kk]
    acc = torch.zeros((n_out, cout), dtype=torch.float32,
                      device=features.device)
    for k0 in range(0, k, group):
        for kk in range(k0, min(k, k0 + group)):
            hit = pos[kk] >= 0
            acc[hit] += part[pos[kk][hit].long()]
    return acc.to(features.dtype)


_MAP_BUFFERS = ("fb", "wb", "cnt", "off", "tile_off", "pair_in", "pos",
                "part", "acc")


@functools.lru_cache(maxsize=256)
def _map_workspace(n_in: int, n_out: int, cin: int, cout: int, k: int,
                   terms: tuple, bn: int, bk: int, group: int) -> tuple:
    """(byte offset of each buffer, in ``_MAP_BUFFERS``' order, in one
    workspace; its size): the bf16 terms fb [TA, N_in, CinF] and wb [TB, K,
    CinW, CoutP] (``map_conv_operands``), the counts [K · row blocks], their
    prefix sums [K · row blocks + 1], the tile prefix sums [K + 1], pair_in
    and pos [K · N_out] (int32), the float32 partials [G · N_out, Cout] and,
    with more than one group, the float32 running sum [N_out, Cout]; each
    256-byte aligned."""
    rb = -(-n_out // MAP_ROWS)
    ta, tb = terms
    sizes = (2 * ta * n_in * _round_up(cin, 8),
             2 * tb * k * _round_up(cin, bk) * _round_up(cout, bn),
             4 * k * rb, 4 * (k * rb + 1), 4 * (k + 1), 4 * k * n_out,
             4 * k * n_out, 4 * group * n_out * cout,
             4 * n_out * cout if group < k else 0)
    offsets, at = [], 0
    for n in sizes:
        offsets.append(at)
        at += _round_up(n, 256)
    return tuple(offsets), at


def _run_map_conv(source: str, features: torch.Tensor, kernel: torch.Tensor,
                  nbr_idx: torch.Tensor, stage: str) -> tuple:
    """Check the operands, allocate the output (in the features' dtype) and
    the workspace, and launch ``csrc/<source>``'s passes up to ``stage`` on
    PyTorch's current stream.  Returns (output, workspace, its offsets,
    (terms, BN, BK)); the workspace is None where an operand is empty
    (nothing launched; the output is then zeros, or has no element)."""
    from ..utils import cuda_build

    if stage not in MAP_STAGES:
        raise ValueError(f"stage {stage!r} not in {MAP_STAGES}")
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
    if k > MAP_MAX_K:
        raise ValueError(f"{k} offsets, more than {MAP_MAX_K}")
    for name, t, dts in (("features", features,
                          (torch.float32, torch.bfloat16)),
                         ("kernel", kernel, (torch.float32, torch.bfloat16)),
                         ("nbr_idx", nbr_idx, (torch.int32,))):
        if t.device != dev or t.dtype not in dts or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous tensor of "
                             f"{' or '.join(map(str, dts))} on {dev}, got "
                             f"{t.dtype} on {t.device}")
    out = torch.empty((n_out, cout), dtype=features.dtype, device=dev)
    terms = MAP_TERMS[source][features.dtype]
    bn, bk = tile_shape(cin, cout, terms)
    if n_out == 0 or cout == 0:
        return out, None, None, (terms, bn, bk)
    if cin == 0 or n == 0 or k == 0:
        return out.zero_(), None, None, (terms, bn, bk)
    group = map_groups(n_out, cout, k)
    offsets, size = _map_workspace(n, n_out, cin, cout, k, terms, bn, bk,
                                   group)
    ws = torch.empty(size, dtype=torch.uint8, device=dev)
    bufs = [ws.data_ptr() + o for o in offsets]
    if group >= k:
        bufs[-1] = None  # no running sum between groups
    stem = source.rsplit(".", 1)[0]
    fn, err = cuda_build.bind(
        source, f"{stem}_forward",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] +
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
        f"{stem}_error_string")
    stream, guard = stream_guard(dev)
    with guard:
        rc = fn(features.data_ptr(), int(features.dtype == torch.bfloat16),
                kernel.data_ptr(), int(kernel.dtype == torch.bfloat16),
                nbr_idx.data_ptr(), out.data_ptr(), *bufs, n, n_out, cin,
                cout, k, bn, bk, group, MAP_STAGES.index(stage), stream)
    if rc != 0:
        raise RuntimeError(f"{stem} launch failed: " + err(rc).decode())
    return out, ws, offsets, (terms, bn, bk)


def launch_map_conv(source: str, features: torch.Tensor,
                    kernel: torch.Tensor,
                    nbr_idx: torch.Tensor) -> tuple:
    """Check the operands, allocate the output in the features' dtype and
    launch ``csrc/<source>`` (B4 or B7, one C signature: every pass of
    ``csrc/map_conv.cuh`` from one call) on PyTorch's current stream.
    Counts nothing: the wrappers do.  Returns the output and whether a
    kernel was launched."""
    out, ws, _, _ = _run_map_conv(source, features, kernel, nbr_idx, "full")
    return out, ws is not None


def _launch_map_conv_passes(source: str, features: torch.Tensor,
                            kernel: torch.Tensor, nbr_idx: torch.Tensor,
                            stage: str) -> tuple:
    """The passes alone on the card, for the card tests that hold them
    equal to their plain versions: ``cast`` gives (fb, wb) as
    ``map_conv_operands``; ``pairs`` (starts, pair_in, pos) as
    ``map_pair_list``."""
    if stage not in MAP_STAGES[1:]:
        raise ValueError(f"stage {stage!r} not in {MAP_STAGES[1:]}")
    _, ws, at, (terms, bn, bk) = _run_map_conv(source, features, kernel,
                                               nbr_idx, stage)
    (n_in, cin), (k, _, cout) = features.shape, kernel.shape
    n_out = nbr_idx.shape[1]

    def view(name, dtype, *shape):
        n = math.prod(shape) * dtype.itemsize
        return ws.narrow(0, at[_MAP_BUFFERS.index(name)], n).view(
            dtype).view(shape)
    if stage == "cast":
        return (view("fb", torch.bfloat16, terms[0], n_in, _round_up(cin, 8)),
                view("wb", torch.bfloat16, terms[1], k, _round_up(cin, bk),
                     _round_up(cout, bn)))
    rb = -(-n_out // MAP_ROWS)
    starts = view("off", torch.int32, k * rb + 1)[::rb].clone()
    return (starts, view("pair_in", torch.int32, k * n_out)[:int(starts[-1])],
            view("pos", torch.int32, k, n_out))


def onehot_sparse_conv(features: torch.Tensor, kernel: torch.Tensor,
                       nbr_idx: torch.Tensor,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """B4: the conv of ``features`` [N, Cin] with ``kernel`` [K, Cin, Cout]
    along ``nbr_idx`` int32[K, N_out] → [N_out, Cout] in the features'
    dtype, with ``compute_dtype`` operands (bf16 by default, as in JAX) and
    float32 accumulation (the operator ``mink_torch::onehot_sparse_conv``,
    whose gradient is ``onehot_conv``'s).

    The JAX kernel's Mosaic parameters ``tile``, ``tw`` and ``interpret``
    are left out: the CUDA kernel's tiles follow ``tile_shape``.  CUDA
    tensors launch the kernel (up to ``MAP_MAX_K`` offsets, a float32 or
    bf16 kernel): bf16 compute ``csrc/onehot_sparse_conv.cu``, float32
    compute the split-term products of ``csrc/pallas_sparse_conv.cu``
    (another ``compute_dtype`` raises); CPU tensors take the plain version
    in ``compute_dtype``."""
    return torch.ops.mink_torch.onehot_sparse_conv(features, kernel, nbr_idx,
                                                   compute_dtype)


# launches of the kernel, counted by its operator's CUDA implementation
onehot_sparse_conv.launches = 0


def _xla_backward(features: torch.Tensor, kernel: torch.Tensor,
                  nbr_idx: torch.Tensor, g: torch.Tensor):
    """(dF, dW) of the conv given a map, JAX's ``_xla_backward``: the
    forward's masked gather for ``dW = einsum("nkc,no->kco")``, and the
    cotangent through ``W_kᵀ`` scattered back with ``index_add_``."""
    k, n_out = nbr_idx.shape
    cin = features.shape[1]
    idx_t = nbr_idx.t().contiguous()
    m = idx_t >= 0
    safe = torch.where(m, idx_t, 0).long()
    gathered = features[safe] * m[..., None].to(features.dtype)
    dkernel = torch.einsum("nkc,no->kco", gathered, g)
    gw = torch.einsum("no,kco->nkc", g, kernel) * m[..., None].to(g.dtype)
    dfeat = torch.zeros_like(features).index_add_(
        0, safe.reshape(-1), gw.reshape(n_out * k, cin).to(features.dtype))
    return dfeat, dkernel


def onehot_conv(features: torch.Tensor, kernel: torch.Tensor,
                nbr_idx: torch.Tensor) -> torch.Tensor:
    """B4, differentiable in ``features`` and ``kernel``: JAX's
    ``onehot_conv`` custom VJP, forward B4 at its default compute dtype,
    backward ``_xla_backward`` in plain PyTorch (the operator's autograd
    formula)."""
    return onehot_sparse_conv(features, kernel, nbr_idx)
