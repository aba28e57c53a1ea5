"""Dense-volume (brick) conv: k=3 s=1 sparse convs computed densely on the
bounded volume, forward and backward, in hand-written CUDA kernels.

Port of `mink_octtree_stablediffusion_tpu/ops/vol_conv.py`.  At fine
strides the occupied voxels are locally dense and a bounded extent makes
the whole volume small, so a self-grid k=3 s=1 conv can scatter its rows
into a zero-padded volume, run a dense conv and gather the output rows
back.  Replaces the TPU kernels of that module:

- **B5**, ``vol_conv_tiles`` (``_kernel``): the dense conv,
  ``csrc/brick_conv.cu``; on the brick route's backward also the dF pass,
  the same conv of the cotangent volume with ``W'[k] = W[26-k]ᵀ``, which
  the source's pack pass applies when it casts the weight to bf16 in the
  order the kernel's tensor cores read, once per launch (its plain
  version: ``pack_weight``);
- **B6**, ``vol_conv_dw`` (``_dw_kernel``): dW, ``csrc/brick_conv_dw.cu``:
  flags for the 4 x 4 x 16-cell tiles whose cotangent is nonzero, a
  tensor-core GEMM over the flagged tiles in splits, and the splits summed
  in order (plain versions of its passes: ``live_tiles``,
  ``_vol_conv_dw_splits_plain``; its plan: ``dw_splits``).

The TPU layout (128-lane channel padding, z padded by 8, brick-order
output) is Mosaic mechanics.  Here a volume is ``[B, X+2, Y+2, Z+2, CP]``
in the compute dtype, with a 1-cell zero shell and the channels padded to
``CP``, a multiple of 16 (the MMA depth); the conv writes a dense float32
``[B, X, Y, Z, Co]`` volume that the gather reads.

Each wrapper (``vol_conv_tiles``, ``vol_conv_dfeatures``, ``vol_conv_dw``)
launches its kernel for CUDA tensors (or raises) and takes its plain
PyTorch version -- 27 shifted slabs of the padded volume, each one float32
GEMM, as ``ops/brick.py::brick_conv_xla`` -- only for tensors on the CPU.
Each counts its launches in ``.launches``.

Routing: ``enable_brick_conv`` (off by default, as in the JAX package)
sends the convs that ``brick_preferred`` accepts through
``brick_pallas_conv``.  The JAX package never takes the route on its CPU
backend; here it is never taken for CPU tensors, so CPU routes stay
equal to JAX's.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .conv import mm_f32
from .coords import SparseGrid, _cells
from .kernels import KernelSpec, RegionType
from ..utils.device import stream_guard

SOURCE = "brick_conv.cu"  # B5 and its dF pass
DW_SOURCE = "brick_conv_dw.cu"  # B6
SOURCES = (SOURCE, DW_SOURCE)
T = 8  # brick side: the route needs cell dims that are multiples of 8
CK = 16  # channel padding of a volume: the MMA depth
MAX_CHANNELS = 1024  # B5's volume channels (csrc MAX_CHUNKS 16-wide chunks)
TILE = (4, 4, 16)  # the kernels' tile of output cells (csrc brick_common.cuh)
# B6's splits: one wave of GEMM blocks, one on each of the card's 132 SMs,
# at most one a tile, and float32 partials [S, 27, Cin, Cout] of at most
# DW_PARTIAL_BYTES
DW_SMS, DW_PARTIAL_BYTES = 132, 16 << 20
# a GEMM block's slab: one dx plane of taps x 64 Cin (csrc BI, the wgmma's
# N) x 64 Cout (BO, its M)
DW_CIN_TILE, DW_COUT_TILE = 64, 64
# B6's passes run up to a stage (csrc ``Stage``, in its order): ``full``
# dW, ``live`` the flags of the live tiles
DW_STAGES = ("full", "live")


def channel_pad(c: int) -> int:
    return max(-(-c // CK) * CK, CK)


def pad_volume(vol: torch.Tensor, compute_dtype=torch.bfloat16
               ) -> torch.Tensor:
    """[B, X, Y, Z, C] → [B, X+2, Y+2, Z+2, CP]: a 1-cell zero shell, the
    channels zero-padded to a multiple of 16, cast to the compute dtype."""
    b, x, y, z, c = vol.shape
    out = torch.zeros((b, x + 2, y + 2, z + 2, channel_pad(c)),
                      dtype=compute_dtype, device=vol.device)
    out[:, 1:-1, 1:-1, 1:-1, :c] = vol.to(compute_dtype)
    return out


def _mirror_transpose(kernel: torch.Tensor) -> torch.Tensor:
    """W'[k] = W[26-k]ᵀ: the dF conv kernel of a k=3 s=1 self-grid conv."""
    return kernel.flip(0).transpose(1, 2)


def _slabs(volp: torch.Tensor, c: int):
    """The 27 shifted [B·X·Y·Z, c] slabs of a padded volume, in tap order
    (C-order over (dx, dy, dz) ∈ {-1,0,1}³)."""
    b, x, y, z = (volp.shape[0], volp.shape[1] - 2, volp.shape[2] - 2,
                  volp.shape[3] - 2)
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                yield volp[:, dx:dx + x, dy:dy + y, dz:dz + z,
                           :c].reshape(-1, c)


def _vol_conv_plain(volp: torch.Tensor, kernel: torch.Tensor,
                    mirror: bool = False) -> torch.Tensor:
    """B5's function (and, with ``mirror``, its dF pass's) in plain
    PyTorch: ``out = Σ_k slab_k · W_k`` in float32 → [B, X, Y, Z, Co]."""
    w = (_mirror_transpose(kernel) if mirror else kernel).to(volp.dtype)
    b, x, y, z = (volp.shape[0], volp.shape[1] - 2, volp.shape[2] - 2,
                  volp.shape[3] - 2)
    out = torch.zeros((b * x * y * z, w.shape[2]), dtype=torch.float32,
                      device=volp.device)
    for k, slab in enumerate(_slabs(volp, w.shape[1])):
        out = out + mm_f32(slab, w[k])
    return out.reshape(b, x, y, z, -1)


def _vol_conv_dw_plain(volp: torch.Tensor, gvolp: torch.Tensor, cin: int,
                       cout: int) -> torch.Tensor:
    """B6's function in plain PyTorch: ``dW[k] = slab_kᵀ · g`` in float32
    → [27, Cin, Cout]; ``gvolp`` is the padded cotangent volume."""
    g = gvolp[:, 1:-1, 1:-1, 1:-1, :cout].reshape(-1, cout)
    return torch.stack([mm_f32(slab.t(), g) for slab in _slabs(volp, cin)])


def n_tiles(b: int, x: int, y: int, z: int) -> int:
    """Tiles of ``TILE`` cells covering a [B, X, Y, Z] volume."""
    return b * math.prod(-(-n // t) for n, t in zip((x, y, z), TILE))


def dw_splits(b: int, x: int, y: int, z: int, cin: int, cout: int) -> int:
    """B6's splits S of the live tiles: as many as one wave of GEMM blocks
    (one on each of ``DW_SMS`` SMs) holds beside the (dx plane, 64-channel
    Cin tile, 64-channel Cout tile) columns, at most one a tile and float32
    partials [S, 27, Cin, Cout] of ``DW_PARTIAL_BYTES``, at least 1: a pure
    function of the shape."""
    cols = 3 * -(-cin // DW_CIN_TILE) * -(-cout // DW_COUT_TILE)
    return max(1, min(DW_SMS // cols, n_tiles(b, x, y, z),
                      DW_PARTIAL_BYTES // (4 * 27 * cin * cout)))


def _tile_of_cell(b: int, x: int, y: int, z: int, device) -> torch.Tensor:
    """int64 [B, X, Y, Z]: each interior cell's tile in the kernels' order
    (``tile_origin``: z tiles fastest, then y, x, the instance)."""
    tx, ty, tz = TILE
    nx, ny, nz = -(-x // tx), -(-y // ty), -(-z // tz)

    def ax(n, t, dims):
        return (torch.arange(n, device=device) // t).view(dims)
    return (((torch.arange(b, device=device).view(-1, 1, 1, 1) * nx +
              ax(x, tx, (1, -1, 1, 1))) * ny + ax(y, ty, (1, 1, -1, 1))) *
            nz + ax(z, tz, (1, 1, 1, -1)))


def live_tiles(gvolp: torch.Tensor, cout: int) -> torch.Tensor:
    """The tiles B6's live pass flags, in the order its GEMM walks them
    (this is that pass's plain version): int32 indices, ascending, of the
    tiles whose cotangent -- channels [0, Cout) of the interior cells --
    holds a nonzero bit."""
    g = gvolp[:, 1:-1, 1:-1, 1:-1, :cout]
    bits = g.view(torch.int16 if g.element_size() == 2 else torch.int32)
    occ = bits.ne(0).any(-1)
    b, x, y, z = occ.shape
    hit = torch.zeros(n_tiles(b, x, y, z), dtype=torch.bool,
                      device=occ.device)
    hit[_tile_of_cell(b, x, y, z, occ.device)[occ]] = True
    return hit.nonzero().flatten().to(torch.int32)


def _vol_conv_dw_splits_plain(volp: torch.Tensor, gvolp: torch.Tensor,
                              cin: int, cout: int,
                              splits: int) -> torch.Tensor:
    """B6's GEMM and reduction in plain PyTorch: the live tiles cut into
    ``splits`` contiguous runs, each run's ``Σ slab_kᵀ · g`` over its
    tiles' cells in float32 (a run with no tile gives zeros), and the runs
    summed in order → float32 [27, Cin, Cout]."""
    live = live_tiles(gvolp, cout).long()
    per = max(1, -(-live.numel() // splits))
    b, x, y, z = (volp.shape[0], volp.shape[1] - 2, volp.shape[2] - 2,
                  volp.shape[3] - 2)
    rank = torch.full((n_tiles(b, x, y, z),), -1, dtype=torch.long,
                      device=volp.device)
    rank[live] = torch.arange(live.numel(), device=volp.device)
    rank = rank[_tile_of_cell(b, x, y, z, volp.device)].reshape(-1)
    split = torch.where(rank >= 0, rank // per, -1)
    g = gvolp[:, 1:-1, 1:-1, 1:-1, :cout].reshape(-1, cout)
    slabs = list(_slabs(volp, cin))
    out = None
    for s in range(splits):
        m = split == s
        part = torch.stack([mm_f32(slab[m].t(), g[m]) for slab in slabs])
        out = part if out is None else out + part
    return out


# -- CUDA launches ------------------------------------------------------------

# kernel entry → (source, its argtypes, error-string function)
_ENTRIES = {
    "brick_conv_forward": (SOURCE,
                           [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 +
                           [ctypes.c_void_p], "brick_conv_error_string"),
    "brick_conv_pack": (SOURCE,
                        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 +
                        [ctypes.c_void_p], "brick_conv_error_string"),
    "brick_conv_dkernel": (DW_SOURCE,
                           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 +
                           [ctypes.c_void_p], "brick_conv_dw_error_string"),
}


def _lib(entry: str):
    from ..utils import cuda_build

    source, argtypes, err = _ENTRIES[entry]
    return cuda_build.bind(source, entry, argtypes, err)


def _check_volume(name: str, t: torch.Tensor, dev, shape4=None):
    if t.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA brick conv computes in bfloat16, not {t.dtype}")
    if (t.device != dev or t.dim() != 5 or not t.is_contiguous() or
            t.shape[-1] % CK or min(t.shape[1:4]) < 3):
        raise ValueError(f"{name}: need a contiguous [B, X+2, Y+2, Z+2, C] "
                         f"volume on {dev} with C a multiple of {CK}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if shape4 is not None and tuple(t.shape[:4]) != shape4:
        raise ValueError(f"{name}: volume {tuple(t.shape)} does not match "
                         f"{shape4}")


def tile_cout(cout: int) -> int:
    """B5's Cout tile NT (16, 32, 64 or 128): one block covers Cout ≤ 128
    whole, so a halo chunk is loaded once per tile."""
    for nt in (16, 32, 64):
        if cout <= nt:
            return nt
    return 128


def pack_weight(kernel: torch.Tensor, mirror: bool = False) -> torch.Tensor:
    """B5's weight as its kernel reads it, the plain version of the pack
    pass that ``brick_conv.cu`` runs before the conv: ``W[27, Cin, Cout]``
    (``W'[k] = W[26-k]ᵀ`` of the forward's kernel for the dF pass,
    ``mirror``) zero-padded to whole 16-channel chunks and NT-wide Cout
    tiles, as bf16 [Cout tiles, Cin chunks, 27, NT/8, 2, 8, 8]:
    ``packed[t, c, k, nb, kb, ni, ki] = W[k, 16c + 8kb + ki, NT·t + 8nb +
    ni]``.  Each tap's 16 × NT slab is in the K-major order of 8 × 8 core
    matrices that the tensor cores read from shared memory, and one ring
    stage of the kernel (9 taps of a chunk and tile) is one contiguous
    slab."""
    w = _mirror_transpose(kernel) if mirror else kernel
    k, cin, cout = w.shape
    nt = tile_cout(cout)
    nch, nct = -(-cin // CK), -(-cout // nt)
    if (nch * CK, nct * nt) != (cin, cout):
        w = torch.nn.functional.pad(w, (0, nct * nt - cout,
                                        0, nch * CK - cin))
    w = w.reshape(k, nch, 2, 8, nct, nt // 8, 8).permute(4, 1, 0, 5, 2, 6, 3)
    return w.to(torch.bfloat16, memory_format=torch.contiguous_format)


def _packed_shape(cin: int, cout: int, nt: int) -> tuple:
    return (-(-cout // nt), -(-cin // CK), 27, nt // 8, 2, 8, 8)


def _check_kernel(kernel: torch.Tensor, dev) -> None:
    if (kernel.device != dev or kernel.dtype != torch.float32 or
            kernel.dim() != 3 or kernel.shape[0] != 27 or
            not kernel.is_contiguous()):
        raise ValueError(f"kernel: need a contiguous float32 [27, Cin, Cout]"
                         f" tensor on {dev}, got {kernel.dtype} "
                         f"{tuple(kernel.shape)} on {kernel.device}")


def _launch_pack(kernel: torch.Tensor, mirror: bool = False) -> torch.Tensor:
    """The pack pass alone on the card (``pack_weight``'s counterpart; B5's
    launch runs it itself), for the card test that holds the two equal."""
    _check_kernel(kernel, kernel.device)
    _, cin, cout = kernel.shape
    if mirror:
        cin, cout = cout, cin
    nt = tile_cout(cout)
    wp = torch.empty(_packed_shape(cin, cout, nt), dtype=torch.bfloat16,
                     device=kernel.device)
    fn, err = _lib("brick_conv_pack")
    stream, guard = stream_guard(kernel.device)
    with guard:
        rc = fn(kernel.data_ptr(), wp.data_ptr(), cin, cout, nt, int(mirror),
                stream)
    if rc != 0:
        raise RuntimeError("brick_conv_pack launch failed: " +
                           err(rc).decode())
    return wp


def _launch(volp: torch.Tensor, kernel: torch.Tensor,
            mirror: bool) -> torch.Tensor:
    """Check the operands, allocate the packed weight and the float32 [B,
    X, Y, Z, Co] output, and launch ``brick_conv.cu`` on PyTorch's current
    stream: its weight pack, then the conv (B5; its dF pass with
    ``mirror``, where ``kernel`` is the forward's [27, Cin, Cout] and the
    pack applies W'[k] = W[26-k]ᵀ).  Counts nothing: the wrappers do."""
    dev = volp.device
    _check_volume("volume", volp, dev)
    _check_kernel(kernel, dev)
    _, cin, cout = kernel.shape
    if mirror:
        cin, cout = cout, cin
    b, xp, yp, zp, cs = volp.shape
    if not 1 <= cin <= cs or cs > MAX_CHANNELS:
        raise ValueError(f"{cin} input channels in a {cs}-channel volume "
                         f"(at most {MAX_CHANNELS})")
    out = torch.empty((b, xp - 2, yp - 2, zp - 2, cout), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    nt = tile_cout(cout)
    wp = torch.empty(_packed_shape(cin, cout, nt), dtype=torch.bfloat16,
                     device=dev)
    fn, err = _lib("brick_conv_forward")
    stream, guard = stream_guard(dev)
    with guard:
        rc = fn(volp.data_ptr(), kernel.data_ptr(), wp.data_ptr(),
                out.data_ptr(), b, xp - 2, yp - 2, zp - 2, cs, cin, cout, nt,
                int(mirror), stream)
    if rc != 0:
        raise RuntimeError("brick_conv launch failed: " + err(rc).decode())
    return out


@functools.lru_cache(maxsize=256)
def _dw_plan(b: int, x: int, y: int, z: int, cin: int, cout: int) -> tuple:
    """B6's plan for a shape: (tiles, splits)."""
    return n_tiles(b, x, y, z), dw_splits(b, x, y, z, cin, cout)


def _run_dw(volp: torch.Tensor, gvolp: torch.Tensor, cin: int, cout: int,
            out: torch.Tensor | None, stage: str = "full",
            splits: int | None = None) -> torch.Tensor:
    """Check the operands, allocate the workspace and launch
    ``brick_conv_dw.cu``'s passes up to ``stage`` on PyTorch's current
    stream with the plan's splits (``_dw_plan``, or ``splits``), writing dW
    into ``out`` (``full``).  The workspace, returned: the live tiles'
    flags uint8 [tiles], then (256-byte aligned, where S > 1) the float32
    partials [S, 27, Cin, Cout]."""
    dev = volp.device
    _check_volume("volume", volp, dev)
    _check_volume("cotangent volume", gvolp, dev, tuple(volp.shape[:4]))
    b, xp, yp, zp, cs = volp.shape
    if not (1 <= cin <= cs and 1 <= cout <= gvolp.shape[-1]):
        raise ValueError(f"{cin}→{cout} channels in volumes of {cs} and "
                         f"{gvolp.shape[-1]}")
    tiles, plan = _dw_plan(b, xp - 2, yp - 2, zp - 2, cin, cout)
    splits = splits or plan
    at_part = -(-tiles // 256) * 256
    ws = torch.empty(at_part + (4 * splits * 27 * cin * cout
                                if splits > 1 else 0),
                     dtype=torch.uint8, device=dev)
    base = ws.data_ptr()
    fn, err = _lib("brick_conv_dkernel")
    stream, guard = stream_guard(dev)
    with guard:
        rc = fn(volp.data_ptr(), gvolp.data_ptr(),
                None if out is None else out.data_ptr(), base,
                base + at_part if splits > 1 else None, b,
                xp - 2, yp - 2, zp - 2, cs, gvolp.shape[-1], cin, cout,
                splits, DW_STAGES.index(stage), stream)
    if rc != 0:
        raise RuntimeError("brick_conv_dkernel launch failed: " +
                           err(rc).decode())
    return ws


def _launch_dw(volp: torch.Tensor, gvolp: torch.Tensor, cin: int,
               cout: int) -> torch.Tensor:
    """Allocate the float32 [27, Cin, Cout] output (no zero fill: every
    element is written) and launch ``brick_conv_dw.cu`` (B6: live tiles,
    GEMM and, with S > 1 splits, the ordered reduce) on PyTorch's current
    stream.  Counts nothing: the wrapper does."""
    out = torch.empty((27, cin, cout), dtype=torch.float32,
                      device=volp.device)
    _run_dw(volp, gvolp, cin, cout, out)
    return out


def _launch_dw_live(gvolp: torch.Tensor, cout: int) -> torch.Tensor:
    """B6's live pass alone on the card: the indices of the tiles it flags
    (``live_tiles``' counterpart), for the card test that holds the two
    equal."""
    b, xp, yp, zp, _ = gvolp.shape
    tiles = n_tiles(b, xp - 2, yp - 2, zp - 2)
    flags = _run_dw(gvolp, gvolp, 1, cout, None, "live")[:tiles]
    return flags.nonzero().flatten().to(torch.int32)


# -- the three wrappers -------------------------------------------------------


def vol_conv_tiles(volp: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """B5: k=3 s=1 VALID conv of the padded volume ``volp`` [B, X+2, Y+2,
    Z+2, CP] with ``kernel`` [27, Cin, Co] → float32 [B, X, Y, Z, Co]."""
    if volp.device.type == "cpu":
        return _vol_conv_plain(volp, kernel)
    out = _launch(volp, kernel, mirror=False)
    if out.numel():  # an empty volume launches nothing
        vol_conv_tiles.launches += 1
    return out


def vol_conv_dfeatures(gvolp: torch.Tensor,
                       kernel: torch.Tensor) -> torch.Tensor:
    """B5's dF pass: the conv of the padded cotangent volume ``gvolp``
    with ``W'[k] = W[26-k]ᵀ`` of the forward's ``kernel`` [27, Cin, Co] →
    float32 [B, X, Y, Z, Cin]."""
    if gvolp.device.type == "cpu":
        return _vol_conv_plain(gvolp, kernel, mirror=True)
    out = _launch(gvolp, kernel, mirror=True)
    if out.numel():
        vol_conv_dfeatures.launches += 1
    return out


def vol_conv_dw(volp: torch.Tensor, gvolp: torch.Tensor, cin: int,
                cout: int) -> torch.Tensor:
    """B6: dW float32 [27, Cin, Cout] from the forward's padded input
    volume and the padded cotangent volume."""
    if volp.device.type == "cpu":
        return _vol_conv_dw_plain(volp, gvolp, cin, cout)
    out = _launch_dw(volp, gvolp, cin, cout)
    vol_conv_dw.launches += 1
    return out


vol_conv_tiles.launches = 0
vol_conv_dfeatures.launches = 0
vol_conv_dw.launches = 0


def vol_conv(vol: torch.Tensor, kernel: torch.Tensor,
             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Dense k=3 s=1 SAME conv, [B, X, Y, Z, C] → float32 [B, X, Y, Z, Co]."""
    return vol_conv_tiles(pad_volume(vol, compute_dtype), kernel)


# -- the differentiable sparse entry ------------------------------------------


def _cell_index(grid: SparseGrid, cells, pad: int) -> torch.Tensor:
    """int64 index of each row's cell in a [B, *(cells + 2·pad)] volume:
    positions clipped into the extent, then shifted by ``pad``."""
    flat = grid.coords[:, 0].long()
    for i, c in enumerate(cells):
        p = torch.div(grid.coords[:, 1 + i], int(grid.stride[i]),
                      rounding_mode="floor")
        flat = flat * (c + 2 * pad) + p.clamp(0, c - 1).long() + pad
    return flat


def _scatter(rows: torch.Tensor, grid: SparseGrid, cells, cd
             ) -> torch.Tensor:
    """The valid rows, cast to ``cd``, in a zero padded volume [B, X+2,
    Y+2, Z+2, CP]; invalid rows are dropped."""
    dims = tuple(c + 2 for c in cells)
    total = grid.batch_size * int(np.prod(dims))
    dest = torch.where(grid.valid, _cell_index(grid, cells, 1), total)
    dense = torch.zeros((total + 1, channel_pad(rows.shape[1])), dtype=cd,
                        device=rows.device)
    dense[dest, :rows.shape[1]] = rows.to(cd)
    return dense[:total].view((grid.batch_size,) + dims + (-1,))


def _gather(out: torch.Tensor, grid: SparseGrid, cells) -> torch.Tensor:
    """Rows of the dense [B, X, Y, Z, C] result at the grid's valid cells;
    zero on padding rows."""
    idx = torch.where(grid.valid, _cell_index(grid, cells, 0), 0)
    rows = out.reshape(-1, out.shape[-1])[idx]
    return rows * grid.valid[:, None].to(rows.dtype)


class BrickConv(torch.autograd.Function):
    """The brick route with its backward as kernels (JAX ``_brick_conv``'s
    custom VJP): forward B5 on the scattered rows; dF the B5 pass on the
    cotangent volume (the cotangent masked and rounded to the compute
    dtype) with the mirrored-transposed kernel; dW B6 from the saved input
    volume and the same cotangent volume.  On the CPU each direction is its
    plain version."""

    @staticmethod
    def forward(ctx, features, kernel, grid, compute_dtype):
        cells = _cells(grid.extent, grid.stride)
        volp = _scatter(features, grid, cells, compute_dtype)
        rows = _gather(vol_conv_tiles(volp, kernel), grid, cells)
        ctx.save_for_backward(volp, kernel)
        ctx.geometry = (grid, cells, compute_dtype)
        return rows.to(features.dtype)

    @staticmethod
    def backward(ctx, g):
        volp, kernel = ctx.saved_tensors
        grid, cells, cd = ctx.geometry
        gvolp = _scatter(g, grid, cells, cd)
        df = dk = None
        if ctx.needs_input_grad[0]:
            df = _gather(vol_conv_dfeatures(gvolp, kernel), grid,
                         cells).to(g.dtype)
        if ctx.needs_input_grad[1]:
            dk = vol_conv_dw(volp, gvolp, kernel.shape[1],
                             kernel.shape[2]).to(kernel.dtype)
        return df, dk, None, None


def brick_pallas_applicable(spec: KernelSpec, grid: SparseGrid) -> bool:
    """k=3 s=1 HYPER_CUBE self-conv on a bounded 3-D extent with 8-aligned
    cell dims, z ≤ 256 cells and at most 4,194,304 cells in all (the JAX
    package's rule, kept as it stands: it decides which convs take the
    route)."""
    if grid.extent is None or grid.ndim != 3 or spec.transpose:
        return False
    if spec.region_type != RegionType.HYPER_CUBE:
        return False
    if any(k != 3 for k in spec.kernel_size) or any(
            s != 1 for s in spec.stride) or any(d != 1 for d in spec.dilation):
        return False
    cells = _cells(grid.extent, grid.stride)
    if any(c % T != 0 for c in cells) or cells[2] > 256:
        return False
    return grid.batch_size * int(np.prod(cells)) <= 4_194_304


def brick_pallas_conv(features: torch.Tensor, kernel: torch.Tensor,
                      grid: SparseGrid,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Differentiable sparse k=3 s=1 self-grid conv of ``features`` [N,
    Cin] with ``kernel`` [27, Cin, Cout] through the dense volume (no
    bias).  The grid must be a bounded 3-D grid with 8-aligned cell dims
    and z ≤ 256 (``brick_pallas_applicable``)."""
    if grid.extent is None or grid.ndim != 3:
        raise ValueError("brick_pallas_conv needs a bounded 3-D grid "
                         "(extent=...)")
    cells = _cells(grid.extent, grid.stride)
    if any(c % T for c in cells) or cells[2] > 256:
        raise ValueError(f"brick_pallas_conv: cell dims {cells} must be "
                         f"multiples of {T} with z <= 256")
    return BrickConv.apply(features, kernel, grid, compute_dtype)


_BRICK_ENABLED = False


def enable_brick_conv(flag: bool) -> None:
    """Route the convs ``brick_preferred`` accepts through the dense-volume
    kernels (default off, as in the JAX package)."""
    global _BRICK_ENABLED
    _BRICK_ENABLED = bool(flag)


def brick_preferred(spec: KernelSpec, grid: SparseGrid, cin: int, cout: int,
                    device) -> bool:
    """Whether a conv of tensors on ``device`` takes the brick route: the
    gate is on, the tensors are not on the CPU, both widths are ≤ 128 and
    the conv is ``brick_pallas_applicable``."""
    if not _BRICK_ENABLED or torch.device(device).type == "cpu":
        return False
    if cin > 128 or cout > 128:
        return False
    return brick_pallas_applicable(spec, grid)
