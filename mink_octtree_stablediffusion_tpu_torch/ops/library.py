"""Every kernel launch of the port as a PyTorch operator (``torch.library``).

The kernels are ``ctypes`` calls on raw device pointers, which neither
``torch.export`` nor a CUDA graph capture can trace.  Here each one is an
operator of the namespace ``mink_torch`` (``torch.ops.mink_torch.<name>``)
with three implementations:

- **CUDA**: the existing launcher, called through its module-global name
  (``fused_conv._launch``, ``_launch_dkernel``, ``vol_conv._launch``,
  ``_launch_dw``, ``onehot_conv.launch_map_conv``), so that whoever wraps a
  launcher sees every launch, also those made from an exported program.
  The launch counters (``fused_sparse_conv.launches`` and the others) are
  counted here, where the kernel launches, and nowhere else.  The fused
  conv's three operators launch once per band of at most
  ``fused_conv.MAX_K`` offsets (``fused_conv.offset_bands``), each launch
  counted, by ``_launch_fused``, also as ``fused_conv.B1``, ``.B2`` or
  ``.B3`` with its work on the innermost ``utils.profiling`` span;
- **CPU**: the kernel's plain PyTorch version;
- **fake**: the output's shape and dtype, for tracing.

The arguments are tensors, ints, int lists, strings and dtypes: a conv's
offsets [K, D] travel as a flat int list, its strides, extents and cells
as int lists, and every grid tensor a backward needs (both grids' flat
keys, coordinates and valid masks) as a tensor input.

- ``fused_conv``: B1, with dF by ``fused_conv_dfeatures`` (B2) and dW
  by ``fused_conv_dkernel`` (B3) as its autograd formula;
- ``fused_conv_stage``: B1 cut at a stage (B8/B9);
- ``brick_conv``: B5 on the rows of a grid (scatter, conv, gather), with
  dF by ``vol_conv_dfeatures`` (B5's dF pass) and dW by ``vol_conv_dw``
  (B6) as its autograd formula; ``vol_conv_tiles``: B5 on a padded
  volume;
- ``onehot_sparse_conv``: B4, with ``onehot_conv._xla_backward`` (plain
  PyTorch, as JAX's) as its autograd formula; ``pallas_sparse_conv``:
  B7.

The backward formulas are those of the autograd Functions they replace
(JAX's custom VJPs), and the backward calls the module-global wrappers
(``fused_conv.fused_conv_dfeatures``, ``vol_conv.vol_conv_dw`` and so on).
The operators are defined with ``torch.library.Library`` (``define`` and
``impl``), whose Python dispatch costs a fraction of
``torch.library.custom_op``'s (on an Intel Xeon with torch 2.13, ~17 µs a
call against ~95 µs): every launch pays it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import fused_conv as fc
from . import onehot_conv as oc
from . import vol_conv as vc
from .coords import SparseGrid, _cells
from ..utils import profiling

NS = "mink_torch"
_LIB = torch.library.Library(NS, "DEF")

_SCHEMAS = {
    "fused_conv": "(Tensor features, Tensor kernel, Tensor in_keys, "
                  "Tensor in_coords, Tensor in_valid, Tensor out_keys, "
                  "Tensor out_coords, Tensor out_valid, int[] offs, "
                  "int[] in_stride, int[] in_extent, int[] out_stride, "
                  "int[] out_extent, ScalarType compute_dtype) -> Tensor",
    "fused_conv_dfeatures": "(Tensor g, Tensor kernel, Tensor out_keys, "
                            "Tensor in_coords, Tensor in_valid, int[] offs, "
                            "int[] out_stride, int[] out_cells, "
                            "ScalarType compute_dtype) -> Tensor",
    "fused_conv_dkernel": "(Tensor features, Tensor g, Tensor in_keys, "
                          "Tensor out_coords, Tensor out_valid, int[] offs, "
                          "int[] in_stride, int[] in_cells, "
                          "ScalarType compute_dtype) -> Tensor",
    "fused_conv_stage": "(Tensor features, Tensor kernel, Tensor in_keys, "
                        "Tensor out_coords, Tensor out_valid, int[] offs, "
                        "int[] in_stride, int[] in_cells, "
                        "ScalarType compute_dtype, str stage) -> Tensor",
    "brick_conv": "(Tensor features, Tensor kernel, Tensor coords, "
                  "Tensor valid, int batch_size, int[] stride, int[] cells, "
                  "ScalarType compute_dtype) -> (Tensor, Tensor)",
    "vol_conv_tiles": "(Tensor volp, Tensor kernel) -> Tensor",
    "vol_conv_dfeatures": "(Tensor gvolp, Tensor kernel) -> Tensor",
    "vol_conv_dw": "(Tensor volp, Tensor gvolp, int cin, int cout) -> Tensor",
    "onehot_sparse_conv": "(Tensor features, Tensor kernel, Tensor nbr_idx, "
                          "ScalarType compute_dtype) -> Tensor",
    "pallas_sparse_conv": "(Tensor features, Tensor kernel, "
                          "Tensor nbr_idx) -> Tensor",
}


def _register(name: str, cuda, cpu, fake) -> None:
    _LIB.define(name + _SCHEMAS[name])
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NS}::{name}", fake, lib=_LIB)


@functools.lru_cache(maxsize=1024)
def _offsets(offs: tuple, d: int) -> np.ndarray:
    """The flat offsets list as the kernels' int32 [K, D] array."""
    return np.asarray(offs, np.int32).reshape(-1, d)


def _geometry(offs, stride, cells) -> tuple:
    return _offsets(tuple(offs), len(stride)), tuple(stride), list(cells)


def _bands(offs, stride, kernel=None) -> list:
    """(flat offsets, the weight's rows) of each launch of a fused conv:
    the bands of ``fused_conv.offset_bands``.  A one-band conv passes the
    weight itself, no view of it."""
    d = len(stride)
    bands = fc.offset_bands(len(offs) // d)
    if len(bands) == 1:
        return [(offs, kernel)]
    return [(offs[k0 * d:k1 * d], None if kernel is None else kernel[k0:k1])
            for k0, k1 in bands]


# -- B1 (fused_conv) with B2 and B3 as its backward ---------------------------


def _launch_fused(wrapper, kind: str, features, operand, in_keys, out_coords,
                  out_valid, offs, stride, cells, compute_dtype,
                  **kw) -> torch.Tensor:
    """One launch of B1, B2 (``kind``; ``operand`` the weight) or B3 (the
    cotangent) through its module-global launcher, counted where it ran:
    in ``wrapper.launches`` and, on the innermost profiling span, as
    ``fused_conv.<kind>`` with its work.  While a profiling record is open
    the kernel adds its matched pairs and valid rows into a slot of the
    record (``fc.WORK.slot``, which the launcher reads)."""
    fc.WORK.slot = slot = profiling.work_slot(features.device)
    try:
        if kind == "B3":
            out = fc._launch_dkernel(features, operand, in_keys, out_coords,
                                     out_valid, *_geometry(offs, stride,
                                                           cells),
                                     compute_dtype)
            ran, cout = operand.numel(), operand.shape[1]
            weight_bytes = out.numel() * 4  # dW written, float32
        else:
            out = fc._launch(features, operand, in_keys, out_coords,
                             out_valid, *_geometry(offs, stride, cells),
                             compute_dtype, **kw)
            ran, cout = out.numel(), out.shape[1]
            weight_bytes = operand.numel() * operand.element_size()
    finally:
        fc.WORK.slot = None
    if ran and features.numel():  # an empty conv launches nothing
        wrapper.launches += 1
        profiling.count_launch(kind, slot, cin=features.shape[1], cout=cout,
                               k=len(offs) // len(stride),
                               weight_bytes=weight_bytes,
                               coord_cols=out_coords.shape[1])
    return out


def _fused_cuda(features, kernel, in_keys, in_coords, in_valid, out_keys,
                out_coords, out_valid, offs, in_stride, in_extent, out_stride,
                out_extent, compute_dtype):
    cells = _cells(in_extent, in_stride)
    out = None
    for band, w in _bands(offs, in_stride, kernel):  # summed in offset order
        part = _launch_fused(fc.fused_sparse_conv, "B1", features, w,
                             in_keys, out_coords, out_valid, band, in_stride,
                             cells, compute_dtype)
        out = part if out is None else out.add_(part)
    return out


def _fused_cpu(features, kernel, in_keys, in_coords, in_valid, out_keys,
               out_coords, out_valid, offs, in_stride, in_extent, out_stride,
               out_extent, compute_dtype):
    geo = _geometry(offs, in_stride, _cells(in_extent, in_stride))
    return fc._fused_sparse_conv_plain(features, kernel, in_keys, out_coords,
                                       out_valid, *geo, compute_dtype)


def _fused_fake(features, kernel, in_keys, in_coords, in_valid, out_keys,
                out_coords, out_valid, offs, in_stride, in_extent, out_stride,
                out_extent, compute_dtype):
    return features.new_empty((out_coords.shape[0], kernel.shape[2]))


def _fused_setup(ctx, inputs, output):
    (features, kernel, in_keys, in_coords, in_valid, out_keys, out_coords,
     out_valid, offs, in_stride, in_extent, out_stride, out_extent,
     cd) = inputs
    ctx.save_for_backward(features, kernel, in_keys, in_coords, in_valid,
                          out_keys, out_coords, out_valid)
    ctx.geometry = (offs, in_stride, in_extent, out_stride, out_extent, cd)


def _fused_backward(ctx, g):
    """JAX ``_fused_conv``'s VJP: dF by B2, dW by B3, through the
    wrappers, on grids rebuilt from the saved tensors."""
    (features, kernel, in_keys, in_coords, in_valid, out_keys, out_coords,
     out_valid) = ctx.saved_tensors
    offs, in_stride, in_extent, out_stride, out_extent, cd = ctx.geometry
    in_grid = SparseGrid(in_coords, in_valid, tuple(in_stride),
                         extent=tuple(in_extent), _flat_keys=in_keys)
    out_grid = SparseGrid(out_coords, out_valid, tuple(out_stride),
                          extent=tuple(out_extent), _flat_keys=out_keys)
    offs_np, s_in, cells = _geometry(offs, in_stride,
                                     _cells(in_extent, in_stride))
    g = g.contiguous()
    df = dk = None
    if ctx.needs_input_grad[0]:
        df = fc.fused_conv_dfeatures(g, kernel, in_grid, out_grid, offs_np,
                                     cd)
    if ctx.needs_input_grad[1]:
        dk = fc.fused_conv_dkernel(features, g, in_grid, out_grid, offs_np,
                                   s_in, cells, cd).to(kernel.dtype)
    return (df, dk) + (None,) * 12


def _dfeatures_cuda(g, kernel, out_keys, in_coords, in_valid, offs,
                    out_stride, out_cells, compute_dtype):
    out = None
    for band, w in _bands(offs, out_stride, kernel):
        part = _launch_fused(fc.fused_conv_dfeatures, "B2", g, w, out_keys,
                             in_coords, in_valid, band, out_stride,
                             out_cells, compute_dtype, transpose_weight=True)
        out = part if out is None else out.add_(part)
    return out


def _dfeatures_cpu(g, kernel, out_keys, in_coords, in_valid, offs,
                   out_stride, out_cells, compute_dtype):
    return fc._fused_sparse_conv_plain(
        g, kernel.transpose(1, 2), out_keys, in_coords, in_valid,
        *_geometry(offs, out_stride, out_cells), compute_dtype)


def _dfeatures_fake(g, kernel, out_keys, in_coords, in_valid, offs,
                    out_stride, out_cells, compute_dtype):
    return g.new_empty((in_coords.shape[0], kernel.shape[1]))


def _dkernel_cuda(features, g, in_keys, out_coords, out_valid, offs,
                  in_stride, in_cells, compute_dtype):
    parts = [_launch_fused(fc.fused_conv_dkernel, "B3", features, g, in_keys,
                           out_coords, out_valid, band, in_stride, in_cells,
                           compute_dtype)
             for band, _ in _bands(offs, in_stride)]  # dW's offset bands
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _dkernel_cpu(features, g, in_keys, out_coords, out_valid, offs,
                 in_stride, in_cells, compute_dtype):
    return fc._dkernel_plain(features, g, in_keys, out_coords, out_valid,
                             *_geometry(offs, in_stride, in_cells),
                             compute_dtype)


def _dkernel_fake(features, g, in_keys, out_coords, out_valid, offs,
                  in_stride, in_cells, compute_dtype):
    return features.new_empty((len(offs) // len(in_stride),
                               features.shape[1], g.shape[1]),
                              dtype=torch.float32)


def _stage_cuda(features, kernel, in_keys, out_coords, out_valid, offs,
                in_stride, in_cells, compute_dtype, stage):
    out = fc._launch(features, kernel, in_keys, out_coords, out_valid,
                     *_geometry(offs, in_stride, in_cells), compute_dtype,
                     stage=stage)
    if out.numel() and features.numel():
        fc.fused_conv_stage.launches += 1
    return out


def _stage_cpu(features, kernel, in_keys, out_coords, out_valid, offs,
               in_stride, in_cells, compute_dtype, stage):
    return fc._stage_plain(features, kernel, in_keys, out_coords, out_valid,
                           *_geometry(offs, in_stride, in_cells),
                           compute_dtype, stage)


def _stage_fake(features, kernel, in_keys, out_coords, out_valid, offs,
                in_stride, in_cells, compute_dtype, stage):
    return features.new_empty(
        (out_coords.shape[0], kernel.shape[2]),
        dtype=features.dtype if stage == "full" else torch.float32)


# -- B5 (brick_conv) with its dF pass and B6 as its backward ------------------


def _tiles_cuda(volp, kernel):
    out = vc._launch(volp, kernel, mirror=False)
    if out.numel():  # an empty volume launches nothing
        vc.vol_conv_tiles.launches += 1
    return out


def _tiles_cpu(volp, kernel):
    return vc._vol_conv_plain(volp, kernel)


def _tiles_fake(volp, kernel):
    b, xp, yp, zp, _ = volp.shape
    return volp.new_empty((b, xp - 2, yp - 2, zp - 2, kernel.shape[2]),
                          dtype=torch.float32)


def _brick_grid(coords, valid, batch_size, stride) -> SparseGrid:
    return SparseGrid(coords, valid, tuple(stride), batch_size)


def _brick(conv, features, kernel, coords, valid, batch_size, stride, cells,
           compute_dtype):
    grid = _brick_grid(coords, valid, batch_size, stride)
    volp = vc._scatter(features, grid, cells, compute_dtype)
    rows = vc._gather(conv(volp, kernel), grid, cells)
    return rows.to(features.dtype), volp


def _brick_cuda(*args):
    return _brick(_tiles_cuda, *args)


def _brick_cpu(*args):
    return _brick(_tiles_cpu, *args)


def _brick_fake(features, kernel, coords, valid, batch_size, stride, cells,
                compute_dtype):
    volume = tuple(c + 2 for c in cells)
    return (features.new_empty((features.shape[0], kernel.shape[2])),
            features.new_empty((batch_size,) + volume +
                               (vc.channel_pad(features.shape[1]),),
                               dtype=compute_dtype))


def _brick_setup(ctx, inputs, output):
    _, kernel, coords, valid, batch_size, stride, cells, cd = inputs
    volp = output[1]  # the scattered input volume, kept for dW
    ctx.mark_non_differentiable(volp)
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(volp, kernel, coords, valid)
    ctx.geometry = (batch_size, stride, cells, cd)


def _brick_backward(ctx, g, _g_volp):
    """JAX ``_brick_conv``'s VJP: the cotangent rows, rounded to the
    compute dtype, scattered into a padded volume; dF by the dF pass, dW by
    B6 from the saved input volume."""
    volp, kernel, coords, valid = ctx.saved_tensors
    batch_size, stride, cells, cd = ctx.geometry
    if g is None:
        return (None,) * 8
    grid = _brick_grid(coords, valid, batch_size, stride)
    gvolp = vc._scatter(g, grid, cells, cd)
    df = dk = None
    if ctx.needs_input_grad[0]:
        df = vc._gather(vc.vol_conv_dfeatures(gvolp, kernel), grid,
                        cells).to(g.dtype)
    if ctx.needs_input_grad[1]:
        dk = vc.vol_conv_dw(volp, gvolp, kernel.shape[1],
                            kernel.shape[2]).to(kernel.dtype)
    return (df, dk) + (None,) * 6


def _vdf_cuda(gvolp, kernel):
    out = vc._launch(gvolp, kernel, mirror=True)
    if out.numel():
        vc.vol_conv_dfeatures.launches += 1
    return out


def _vdf_cpu(gvolp, kernel):
    return vc._vol_conv_plain(gvolp, kernel, mirror=True)


def _vdf_fake(gvolp, kernel):
    b, xp, yp, zp, _ = gvolp.shape
    return gvolp.new_empty((b, xp - 2, yp - 2, zp - 2, kernel.shape[1]),
                           dtype=torch.float32)


def _vdw_cuda(volp, gvolp, cin, cout):
    out = vc._launch_dw(volp, gvolp, cin, cout)
    vc.vol_conv_dw.launches += 1
    return out


def _vdw_cpu(volp, gvolp, cin, cout):
    return vc._vol_conv_dw_plain(volp, gvolp, cin, cout)


def _vdw_fake(volp, gvolp, cin, cout):
    return volp.new_empty((27, cin, cout), dtype=torch.float32)


# -- B4 (with JAX's plain backward) and B7 ------------------------------------


def _onehot_cuda(features, kernel, nbr_idx, compute_dtype):
    # float32 compute is B7's function: its split-term instantiation
    sources = {torch.bfloat16: oc.SOURCE, torch.float32: oc.SOURCES[1]}
    if compute_dtype not in sources:
        raise NotImplementedError(
            "the CUDA one-hot conv computes in bfloat16 or float32, not "
            f"{compute_dtype}")
    out, launched = oc.launch_map_conv(sources[compute_dtype], features,
                                       kernel, nbr_idx)
    oc.onehot_sparse_conv.launches += launched
    return out


def _onehot_cpu(features, kernel, nbr_idx, compute_dtype):
    return oc.map_conv_plain(features, kernel, nbr_idx, compute_dtype)


def _map_fake(features, kernel, nbr_idx, *_):
    return features.new_empty((nbr_idx.shape[1], kernel.shape[2]))


def _onehot_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:3])


def _onehot_backward(ctx, g):
    features, kernel, nbr_idx = ctx.saved_tensors
    df, dk = oc._xla_backward(features, kernel, nbr_idx, g.contiguous())
    return df, dk.to(kernel.dtype), None, None


def _pallas_cuda(features, kernel, nbr_idx):
    from .pallas_conv import SOURCE, pallas_sparse_conv

    out, launched = oc.launch_map_conv(SOURCE, features, kernel, nbr_idx)
    pallas_sparse_conv.launches += launched
    return out


def _pallas_cpu(features, kernel, nbr_idx):
    return oc.map_conv_plain(features, kernel, nbr_idx, torch.float32)


_register("fused_conv", _fused_cuda, _fused_cpu, _fused_fake)
_register("fused_conv_dfeatures", _dfeatures_cuda, _dfeatures_cpu,
          _dfeatures_fake)
_register("fused_conv_dkernel", _dkernel_cuda, _dkernel_cpu, _dkernel_fake)
_register("fused_conv_stage", _stage_cuda, _stage_cpu, _stage_fake)
_register("brick_conv", _brick_cuda, _brick_cpu, _brick_fake)
_register("vol_conv_tiles", _tiles_cuda, _tiles_cpu, _tiles_fake)
_register("vol_conv_dfeatures", _vdf_cuda, _vdf_cpu, _vdf_fake)
_register("vol_conv_dw", _vdw_cuda, _vdw_cpu, _vdw_fake)
_register("onehot_sparse_conv", _onehot_cuda, _onehot_cpu, _map_fake)
_register("pallas_sparse_conv", _pallas_cuda, _pallas_cpu, _map_fake)
torch.library.register_autograd(f"{NS}::fused_conv", _fused_backward,
                                setup_context=_fused_setup, lib=_LIB)
torch.library.register_autograd(f"{NS}::brick_conv", _brick_backward,
                                setup_context=_brick_setup, lib=_LIB)
torch.library.register_autograd(f"{NS}::onehot_sparse_conv",
                                _onehot_backward, setup_context=_onehot_setup,
                                lib=_LIB)

OPS = tuple(_SCHEMAS)  # every operator of the namespace


def launch_counters() -> tuple:
    """The wrappers whose ``.launches`` the operators count, each launch
    where it ran (a CUDA graph's runner advances them on a replay)."""
    from .pallas_conv import pallas_sparse_conv

    return (fc.fused_sparse_conv, fc.fused_conv_dfeatures,
            fc.fused_conv_dkernel, fc.fused_conv_stage, vc.vol_conv_tiles,
            vc.vol_conv_dfeatures, vc.vol_conv_dw, oc.onehot_sparse_conv,
            pallas_sparse_conv)
