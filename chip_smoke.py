"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py               # from the root of a checkout
    python3 chip_smoke.py --profile     # also profile a request and steps
    python3 chip_smoke.py --max-keep 0  # no generation clamp (MAX_KEEP)

Builds the port's CUDA kernels from `mink_octtree_stablediffusion_tpu_torch/
csrc/` (one ``nvcc`` per source, all at once) and drives the port's three
paths, each with the kernels' launch counts set to 0 just before it and
read just after:

- **generation** — `serve.build_generate_fn` of `examples/generate.py`'s
  default configuration with the DDIM scheduler (resolution 128, batch 4,
  65536 input rows, VAE (32, 128, 512, 512, 4), UNet (4, 320, 640, 960) at
  full width, random weights from seed 0), cut to 8 DDIM steps, for 3
  requests (seeds 0, 1, 2).  Each request must give finite features and
  > 0 voxels per instance, and every fused-route conv must launch the
  forward kernel (B1).
- **VAE training** — `examples/train_vae.py`'s default configuration (the
  same VAE with the `capacities()` schedule, Adam at lr 1e-3,
  ``kld_weight`` 1e-6, random weights from seed 0): 10 steps of
  ``train.make_train_step`` on one fixed batch of 4 `SyntheticShapes` at
  resolution 128.  Every loss and gradient must be finite, every parameter
  must get a gradient, every fused-route conv must launch B1 and dW (B3)
  and, where its input carries a gradient, dF (B2), and the loss must fall
  (see ``train_phase``).  Before the steps, step 1 runs with the brick
  gate (``ops.enable_brick_conv``) off and then on, the BatchNorm
  statistics restored in between: the loss and the gradients must agree
  (``gate_compare``), and must not with a fault planted in the dF pass
  (``planted_fault``); the gate-on step puts the brick kernels (B5, its
  dF pass, B6) at the VAE's widths.
- **diffusion training** — `examples/train_diffusion.py`'s default
  configuration through ``train.diffusion.setup`` (the frozen VAE and the
  UNet above, DDPM with 1000 steps, AdamW at lr 1e-4 with global-norm
  clipping 0.5 and weight decay 1e-2, the coordinate NLL, seed 0) with the
  brick gate on: 10 steps on one fixed batch of 4 `SyntheticShapes`
  (samples 0-3).  Cut to size: one (timesteps, noise) draw replayed at
  every step and the warmup cut from 1000 steps to 1, so that the
  denoise loss can be seen to fall.  Every loss and gradient must be
  finite, every UNet and NLL parameter must get a gradient, every
  brick-route conv must launch B5, every fused-route conv B1, and, where
  the conv's kernel is trained (not the frozen VAE's) and its input
  carries a gradient, B6/B3 and the dF pass/B2; each step's lr must equal
  ``warmup_cosine``'s; the denoise loss of step 10 must be below step
  1's.  Before the steps, step 1 runs with the gate off and then on
  (``gate_compare``, with its planted fault).
- **the library path** — `bench_conv`, the counterpart of `bench.py`'s
  conv metric and its stage scripts, on its three workloads (seed 0): the
  room (26,098 points, 3→32), the finest octree level (131,072 rows,
  32→32) and a 512→512 encoder level, driven once per workload (the
  room's pipeline through B1, B4 and B7; B4 and B7 alone on the others;
  B1's stages, B8 on the room and B9 on the finest level).  Every kernel
  of the path must launch; see ``library_phase`` for what it holds.

Then every kernel is held against its plain PyTorch version on the same
bf16-rounded operands, at the shapes its paths gave it (B1 also at a few
extra cases; the backward kernels with the captured cotangent scaled by a
power of two to unit RMS, see ``unit_rms``), within ``1e-3·max|ref| +
1e-5``, and timed (CUDA events, median of 25 after warm-up) beside its
bound, its plain version and, for the brick kernels, one cuDNN call that
computes the same function.  B1's stages (the cut that B8/B9 time on
the library path) are also timed on the generation path's two heaviest
launch shapes (``stage_table``), and B3's passes, each by its device time,
on the VAE step's two heaviest (``b3_pass_table``, which also holds two
launches bit for bit equal), and B6's passes at every B6 launch shape of
the VAE gate-on step and the diffusion step (``b6_pass_table``: the
same, with the share of live tiles).
B1, B2 and B3 are all checked at every launch
shape of the VAE train path, so that its kernel account is complete
(``vae_step_kernel_account``).  Last, tiny configurations run on the card
and on the CPU (plain versions under the same bf16 compute policy) with
the same weights, inputs and noise: a generation (``tiny_reference``), a
VAE train step (``tiny_train_reference``) and a diffusion train step with
the brick gate on (``tiny_diffusion_reference``, which also runs the card
with the gate off and with the planted fault) must agree within the
tolerances stated there.

The generation decoder clamps each level to ``MAX_KEEP`` rows (see there);
VAE training runs unclamped (see ``train_phase``).

Prints one JSON line per case, request and step, the launch-shape
histograms, the card's name and power limit, a ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import statistics
import sys
import time
import traceback
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# B7 on float32 features against its float32 plain version: max|Δ| ≤
# B7_F32_RTOL·max|ref|, above float32 summation-order error and below
# what TF32 (10-bit mantissa) or bf16 rounding of the operands gives
B7_F32_RTOL = 2e-5
RES, BATCH, CAP, STEPS = 128, 4, 65536, 8
VAE_CH, UNET_CH, GROUP = (32, 128, 512, 512, 4), (4, 320, 640, 960), 32
DEVICE = "cuda"
# The decoder's per-level top-k clamp (`VAE.max_keep`).  Random occupancy
# heads keep about two thirds of each level's candidates, where a trained
# decoder keeps the shape's surface; the 8x growth then overflows the
# level buffers (16384, 32768, 131072 rows), and an overflowing buffer
# keeps the lowest keys, so it drops the batch's later instances whole (the
# JAX package does the same).  2048 = 16384 // 8 lets every level's growth
# fit its buffer.
MAX_KEEP = 2048
# tiny_train_reference's bounds on the relative RMS, card vs CPU, of each
# gradient and of each running-statistic update (see there)
TINY_GRAD_RTOL, TINY_STAT_RTOL = 0.075, 0.02
TRAIN_STEPS, TRAIN_LR, TRAIN_KLD = 10, 1e-3, 1e-6  # train_vae.py's defaults
# diffusion phase: 10 steps; the warmup cut from 1000 to 1 (see the module
# docstring); seed 0 for the weights, as the other paths
DIFF_STEPS, DIFF_FLAGS = 10, ["--seed", "0", "--warmup", "1"]
# gate_compare's bounds, gate off vs gate on at step 1 (see there): the
# loss's relative difference, and the relative RMS of the gradients at the
# median tensor and at the worst.  Measured on the H100 (80GB HBM3, 700 W):
# VAE 6.6e-5, 0.019, 0.034; diffusion 1.9e-5, 0.078, 0.33
GATE_TOL = {"vae": {"loss": 1e-3, "grad_median": 0.05, "grad_max": 1.0},
            "diffusion": {"loss": 1e-3, "grad_median": 0.25,
                          "grad_max": 1.0}}
# tiny_diffusion_reference's bounds (see there): the loss, card vs CPU,
# relative; the UNet gradients' median relative RMS against a control's
TINY_DIFF_LOSS_RTOL, TINY_DIFF_RATIO = 1e-2, 3.0
CSRC = "mink_octtree_stablediffusion_tpu_torch/csrc/"
JAX_CONV = "mink_octtree_stablediffusion_tpu/ops/onehot_conv.py"
JAX_VOL = "mink_octtree_stablediffusion_tpu/ops/vol_conv.py"
# kernel: (module in ops/, wrapper, source, the TPU kernel it replaces)
KERNELS = {
    "B1": ("fused_conv", "fused_sparse_conv", CSRC + "fused_sparse_conv.cu",
           JAX_CONV + ":553"),  # _fused_impl, pallas_call :831
    "B2": ("fused_conv", "fused_conv_dfeatures",
           CSRC + "fused_sparse_conv.cu",
           JAX_CONV + ":1186"),  # _fused_impl on _FusedStatic.flipped
    "B3": ("fused_conv", "fused_conv_dkernel",
           CSRC + "fused_sparse_conv_dw.cu",
           JAX_CONV + ":935"),  # _dkernel_fused, pallas_call :1146
    "B5": ("vol_conv", "vol_conv_tiles", CSRC + "brick_conv.cu",
           JAX_VOL + ":98"),  # vol_conv_tiles, pallas_call :132
    "B5-dF": ("vol_conv", "vol_conv_dfeatures", CSRC + "brick_conv.cu",
              JAX_VOL + ":333"),  # vol_conv_tiles in _brick_bwd's dF
    "B6": ("vol_conv", "vol_conv_dw", CSRC + "brick_conv_dw.cu",
           JAX_VOL + ":228"),  # vol_conv_dw, pallas_call :254
}
FUSED, BRICK = ("B1", "B2", "B3"), ("B5", "B5-dF", "B6")
# the library path's kernels (`bench_conv`), in KERNELS' form
LIBRARY_KERNELS = {
    "B4": ("onehot_conv", "onehot_sparse_conv",
           CSRC + "onehot_sparse_conv.cu",
           JAX_CONV + ":306"),  # onehot_sparse_conv, pallas_call :385
    "B7": ("pallas_conv", "pallas_sparse_conv",
           CSRC + "pallas_sparse_conv.cu",
           "mink_octtree_stablediffusion_tpu/ops/pallas_conv.py:37"),  # :78
    "B8": ("fused_conv", "fused_conv_stage", CSRC + "fused_sparse_conv.cu",
           "scripts/bench_kernel_parts.py:55"),  # variant_conv, :199
    "B9": ("fused_conv", "fused_conv_stage", CSRC + "fused_sparse_conv.cu",
           "scripts/bench_parts_finest.py:85"),  # variant, :189
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def decoder_levels(out_clss, batch: int) -> list:
    """Candidate rows per instance at each decoder level, with the level's
    buffer capacity (a level whose rows fill its buffer has overflowed)."""
    import torch
    return [{"capacity": lt.capacity,
             "rows_per_instance": torch.bincount(
                 lt.grid.coords[lt.valid][:, 0].long(),
                 minlength=batch).tolist()} for lt in out_clss]


class LaunchCapture:
    """Wraps the launchers of B1 and B2 (``fused_conv._launch``, B2 with
    ``transpose_weight``), B3 (``_launch_dkernel``), B5 and its dF pass
    (``vol_conv._launch``, dF with ``mirror``) and B6 (``_launch_dw``).
    While ``path`` is set (``at``), it counts each kernel's launches by
    launch shape (``counts[path][kernel]``), lists B5's forward launch
    shapes in order (``b5_order[path]``) and, for the kernels in ``on``,
    keeps the operands of the first launch of each shape
    (``cases[path][kernel]``), with no extra launches.  A fused-conv shape
    is the forward conv's (N_out, Cin, Cout, K); a brick shape the forward
    conv's (B, X, Y, Z, Cin, Cout)."""

    def __init__(self, mp):
        self.fc, self.vc = mp.ops.fused_conv, mp.ops.vol_conv
        self.orig = (self.fc._launch, self.fc._launch_dkernel,
                     self.vc._launch, self.vc._launch_dw)
        self.cases, self.counts, self.b5_order = {}, {}, {}
        self.path, self.on = None, ()

    def at(self, path, on=()):
        self.path, self.on = path, tuple(on)

    def case(self, path, name) -> dict:
        return self.cases.get(path, {}).get(name, {})

    def per_step(self, path, name, steps: int) -> Counter:
        total = self.counts.get(path, {}).get(name, Counter())
        assert all(c % steps == 0 for c in total.values()), (path, name)
        return Counter({k: c // steps for k, c in total.items()})

    def keep(self, name, key, ops):
        if self.path is None:
            return
        self.counts.setdefault(self.path, {}).setdefault(
            name, Counter())[key] += 1
        if name == "B5":
            self.b5_order.setdefault(self.path, []).append(key)
        if name in self.on:
            self.cases.setdefault(self.path, {}).setdefault(
                name, {}).setdefault(key, ops)

    def __enter__(self):
        launch, launch_dkernel, vlaunch, vlaunch_dw = self.orig

        def b1_b2(*a, transpose_weight=False):
            w = a[1]  # the forward's [K, Cin, Cout]
            self.keep("B2" if transpose_weight else "B1",
                      (a[0].shape[0] if transpose_weight else a[3].shape[0],
                       w.shape[1], w.shape[2], w.shape[0]), a[:8])
            return launch(*a, transpose_weight=transpose_weight)

        def b3(*a):
            f, g, offs = a[0], a[1], a[5]
            self.keep("B3", (g.shape[0], f.shape[1], g.shape[1],
                             offs.shape[0]), a[:8])
            return launch_dkernel(*a)

        def b5(volp, kernel, mirror):
            b, xp, yp, zp, _ = volp.shape
            self.keep("B5-dF" if mirror else "B5",
                      (b, xp - 2, yp - 2, zp - 2) + tuple(kernel.shape[1:]),
                      (volp, kernel, mirror))
            return vlaunch(volp, kernel, mirror)

        def b6(volp, gvolp, cin, cout):
            b, xp, yp, zp, _ = volp.shape
            self.keep("B6", (b, xp - 2, yp - 2, zp - 2, cin, cout),
                      (volp, gvolp, cin, cout))
            return vlaunch_dw(volp, gvolp, cin, cout)

        (self.fc._launch, self.fc._launch_dkernel, self.vc._launch,
         self.vc._launch_dw) = (b1_b2, b3, b5, b6)
        return self

    def __exit__(self, *exc):
        (self.fc._launch, self.fc._launch_dkernel, self.vc._launch,
         self.vc._launch_dw) = self.orig
        self.path = None


def unit_rms(g):
    """``g`` times the power of two that brings its RMS nearest 1.  B2 and
    B3 are linear in the cotangent, and a power-of-two scale commutes with
    bf16 rounding and float32 sums, so the kernels are checked on the
    captured operands up to an exact scale.  Step 1's cotangents are tiny
    (an RMS of 1e-9 to 1e-4), and unscaled the ``1e-5`` term of the
    tolerance would pass a kernel that returned zeros."""
    rms = g.float().square().mean().sqrt().item()
    return (g * 2.0 ** -round(math.log2(rms)) if rms > 0 else g), rms


def rel_rms(a: dict, ref: dict) -> dict:
    """‖a − ref‖ / ‖ref‖ per name."""
    return {n: float((a[n] - ref[n]).norm() / ref[n].norm().clamp(
        min=1e-30)) for n in ref}


def matched_pairs(fc, keys, out_coords, out_valid, offs, s, cells) -> int:
    qk = fc.query_keys(out_coords, out_valid, offs, s, cells)
    return int((fc.neighbor_index(keys, qk) >= 0).sum().item())


def timed_check(kernel, case, kind, run, plain, pairs, cin, cout, nbytes,
                min_ref=0.0, library=None, work_pairs=None, flops=None,
                fp32_flops=False, rel_tol=1e-3, abs_tol=1e-5, extra_ok=True,
                bf16_out=False, **shape):
    """Kernel vs plain version: max|Δ| ≤ ``rel_tol``·max|ref| +
    ``abs_tol`` (by default 1e-3·max|ref| + 1e-5), and max|ref| ≥
    ``min_ref`` (so that a kernel returning zeros fails); CUDA-event times
    of both and of ``library`` (one PyTorch call computing the same
    function), where there is one; the bound max(flops / peak bf16,
    bytes / peak HBM), the flops being 2·Cin·Cout·``pairs`` (``work_pairs``
    in place of the matched ``pairs`` where the function's terms are others)
    unless ``flops`` is given.  Where the kernel does its operations as
    float32 FMAs outside the tensor cores (``fp32_flops``), the record also
    holds ``bound_fp32_ms``, the same bound at the float32 peak.  The
    record is ok only with ``extra_ok`` too (the caller's own checks).  A
    bf16 output (``bf16_out``) is held to one bf16 ulp of max|ref|,
    2^(⌊log₂ max|ref|⌋ − 7), + ``abs_tol`` in place of the relative term:
    the kernel and its plain version each round a float32 sum to bf16, and
    sums that differ in their last float32 bits may round to neighbouring
    bf16 values, 2⁻⁸ to 2⁻⁷ of the value apart (above 1e-3)."""
    from mink_octtree_stablediffusion_tpu_torch.bench_conv import cuda_time_ms
    import torch
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item() if out.numel() \
        else 0.0
    ref_max = ref.float().abs().max().item() if ref.numel() else 0.0
    tol = rel_tol * ref_max + abs_tol
    if bf16_out and ref_max > 0:
        tol = 2.0 ** (math.floor(math.log2(ref_max)) - 7) + abs_tol
    del out, ref
    if flops is None:
        flops = 2.0 * cin * cout * (work_pairs or pairs)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    rec = {"kernel": kernel, "case": case, "kind": kind, **shape,
           "cin": cin, "cout": cout, "matched_pairs": pairs,
           "max_abs_err": err, "max_abs_ref": ref_max, "tol": tol,
           "rel_err": err / ref_max if ref_max else 0.0,
           "ms": cuda_time_ms(run), "plain_ms": cuda_time_ms(plain),
           "library_ms": cuda_time_ms(library) if library else None,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes,
           "ok": bool(err <= tol and math.isfinite(err) and
                      ref_max >= min_ref and extra_ok)}
    if fp32_flops:
        rec["bound_fp32_ms"] = max(flops / PEAK_F32_FLOPS * 1e3, t_bytes)
    emit(rec)
    return rec


# B2's and B3's checks run on a unit-RMS cotangent (``unit_rms``) and also
# need max|ref| ≥ 1e-2, where the tolerance's relative term is at least its
# 1e-5 term
MIN_REF_GRAD = 1e-2


def check_conv_launch(mp, kernel, case, kind, ops, transpose_weight=False,
                      **extra):
    """B1, or B2 with ``transpose_weight``: ``ops`` = (features, weight,
    keys, out_coords, out_valid, offs, stride, cells) of one launch, B2's
    features being the cotangent, checked at unit RMS.  Bytes: the
    features, the weight, the keys and the output coordinates and valid
    mask read once, the output written once."""
    import torch
    fc = mp.ops.fused_conv
    f, w, keys, oc, ov, offs, s, cells = ops
    if transpose_weight:
        f, extra["g_rms"] = unit_rms(f)
        ops = (f,) + tuple(ops[1:])
        extra["min_ref"] = MIN_REF_GRAD
    f16, w16 = f.bfloat16().float(), w.bfloat16().float()
    wp = w16.transpose(1, 2) if transpose_weight else w16
    k, cin, cout = wp.shape
    n_out = oc.shape[0]
    nbytes = (4 * f.numel() + 4 * w.numel() + 4 * keys.numel() +
              17 * n_out + 4 * n_out * cout)
    return timed_check(
        kernel, case, kind,
        lambda: fc._launch(*ops, torch.bfloat16,
                           transpose_weight=transpose_weight),
        lambda: fc._fused_sparse_conv_plain(f16, wp, keys, oc, ov, offs, s,
                                            cells, torch.float32),
        matched_pairs(fc, keys, oc, ov, offs, s, cells), cin, cout, nbytes,
        n_out=n_out, n_in=f.shape[0], k=k, **extra)


def check_case(mp, name, kind, features, kernel, in_grid, out_grid, spec):
    """B1 on one conv's operands."""
    offs, s_in, cells = mp.ops.fused_conv.conv_geometry(in_grid, spec)
    return check_conv_launch(mp, "B1", name, kind, (
        features, kernel, in_grid.flat_keys(), out_grid.coords,
        out_grid.valid, offs, s_in, cells))


def check_dkernel_launch(mp, case, kind, ops):
    """B3: ``ops`` = (features, g, keys, out_coords, out_valid, offs,
    stride, cells) of one launch, checked with ``g`` at unit RMS.  Bytes:
    the features, the cotangent, the keys and the output coordinates and
    valid mask read once, dW (float32 [K, Cin, Cout]) written once."""
    import torch
    fc = mp.ops.fused_conv
    f, g, keys, oc, ov, offs, s, cells = ops
    g, g_rms = unit_rms(g)
    ops = (f, g) + tuple(ops[2:])
    f16, g16 = f.bfloat16().float(), g.bfloat16().float()
    k, (n_in, cin), (n_out, cout) = offs.shape[0], f.shape, g.shape
    nbytes = (4 * f.numel() + 4 * g.numel() + 4 * keys.numel() +
              17 * n_out + 4 * k * cin * cout)
    return timed_check(
        "B3", case, kind,
        lambda: fc._launch_dkernel(*ops, torch.bfloat16),
        lambda: fc._dkernel_plain(f16, g16, keys, oc, ov, offs, s, cells,
                                  torch.float32),
        matched_pairs(fc, keys, oc, ov, offs, s, cells), cin, cout, nbytes,
        min_ref=MIN_REF_GRAD, n_out=n_out, n_in=n_in, k=k, g_rms=g_rms)


def occupied_pairs(occ_out, occ_in) -> int:
    """(output cell, neighbour) pairs of a k=3 s=1 conv where both are
    occupied: ``occ_*`` are [B, X+2, Y+2, Z+2] occupancy of padded
    volumes (a cell is occupied where any channel is nonzero)."""
    x, y, z = (occ_in.shape[1] - 2, occ_in.shape[2] - 2,
               occ_in.shape[3] - 2)
    inner = occ_out[:, 1:-1, 1:-1, 1:-1]
    return sum(int((inner & occ_in[:, dx:dx + x, dy:dy + y,
                                   dz:dz + z]).sum().item())
               for dx in range(3) for dy in range(3) for dz in range(3))


def check_brick_launch(mp, kernel, path, key, ops):
    """B5 (forward), its dF pass or B6 on one launch's operands (``key``:
    the forward conv's (B, X, Y, Z, Cin, Cout)); the dF pass and B6 with
    the cotangent volume at unit RMS.  Bound: the operations, against the
    bytes the function must move at the conv's own widths: the bf16 input
    (and, for B6, cotangent) values of the volume's cells read once, the
    float32 weight read once (B5, dF) or written once (B6), the float32
    output written once.  The 1-cell zero shell and the channel padding to
    16 are the port's layout and are not counted.  ``matched_pairs``
    counts the occupied (cell, neighbour) pairs, B1's work for the same
    conv.  Operations: 2·Cin·Cout for each (cell, neighbour) term the
    function's sums hold (``work_pairs``): for B5 and the dF pass, whose
    output is dense, every cell's occupied neighbours; for B6, whose sum
    has a term only where the cotangent's cell and its neighbour are both
    occupied, ``matched_pairs``.  The record keeps the time of the dense
    work, 2·27·cells·Cin·Cout operations, beside it (``dense_ops_ms``).
    Yardstick
    (``library_ms``): one cuDNN call on a dense, contiguous bf16 copy of
    the volume at the conv's widths, made before the timing: ``F.conv3d``
    (B5 and the dF pass) or ``torch.nn.grad.conv3d_weight`` (B6)."""
    import torch
    import torch.nn.functional as F
    vc = mp.ops.vol_conv
    b, x, y, z = key[:4]
    cells = b * x * y * z
    extra, min_ref = {}, 0.0
    if kernel == "B6":
        volp, gvolp, cin, cout = ops
        gvolp, extra["g_rms"] = unit_rms(gvolp)
        min_ref = MIN_REF_GRAD
        xin = volp[..., :cin].permute(0, 4, 1, 2, 3).contiguous()
        gout = gvolp[:, 1:-1, 1:-1, 1:-1, :cout].permute(
            0, 4, 1, 2, 3).contiguous()
        run = lambda: vc._launch_dw(volp, gvolp, cin, cout)  # noqa: E731
        plain = lambda: vc._vol_conv_dw_plain(  # noqa: E731
            volp, gvolp, cin, cout)
        library = lambda: torch.nn.grad.conv3d_weight(  # noqa: E731
            xin, (cout, cin, 3, 3, 3), gout)
        nbytes = 2 * cells * (cin + cout) + 4 * 27 * cin * cout
        pairs = occupied_pairs(gvolp.ne(0).any(-1), volp.ne(0).any(-1))
        work = pairs
    else:
        volp, w, mirror = ops
        if mirror:
            volp, extra["g_rms"] = unit_rms(volp)
            min_ref = MIN_REF_GRAD
        wk = vc._mirror_transpose(w) if mirror else w
        cin, cout = wk.shape[1], wk.shape[2]
        xin = volp[..., :cin].permute(0, 4, 1, 2, 3).contiguous()
        wl = wk.to(volp.dtype).reshape(3, 3, 3, cin, cout).permute(
            4, 3, 0, 1, 2).contiguous()
        run = lambda: vc._launch(volp, w, mirror)  # noqa: E731
        plain = lambda: vc._vol_conv_plain(volp, w, mirror)  # noqa: E731
        library = lambda: F.conv3d(xin, wl)  # noqa: E731
        nbytes = 2 * cells * cin + 4 * w.numel() + 4 * cells * cout
        occ = volp.ne(0).any(-1)
        pairs = occupied_pairs(occ, occ)
        work = occupied_pairs(torch.ones_like(occ), occ)
    return timed_check(kernel, path, "k3s1", run, plain, pairs, cin, cout,
                       nbytes, min_ref=min_ref, library=library,
                       work_pairs=work, volume=[b, x, y, z], cells=cells,
                       forward_shape=list(key), dense_ops_ms=2.0 * 27 *
                       cells * cin * cout / PEAK_BF16_FLOPS * 1e3, **extra)


def extra_cases(mp, st, dev):
    """Extra cases on the real input geometry: k3s1 at Cin 1 and 4, a
    strided k3s2, a pinned k2s2 transpose, a k2s2 growth onto an
    ``expand_grid`` output, a 960-wide k3s1 and an empty grid."""
    import torch
    g = torch.Generator(device=dev).manual_seed(7)
    KS = mp.ops.KernelSpec
    g1 = st.grid
    g2 = mp.ops.stride_grid(g1, 2, CAP // 2)
    g8 = mp.ops.stride_grid(g1, 8, CAP // 16)
    g16 = mp.ops.stride_grid(g1, 16, 2048)
    s8 = KS(2, 2, ndim=3, transpose=True)
    g4_grown = mp.ops.expand_grid(g8, s8.absolute_offsets(g8.stride),
                                  s8.out_stride(g8.stride), CAP // 4)
    empty = mp.ops.SparseGrid(
        coords=torch.full((1024, 4), mp.ops.INVALID_COORD, dtype=torch.int32,
                          device=dev),
        valid=torch.zeros(1024, dtype=torch.bool, device=dev),
        stride=(1, 1, 1), batch_size=BATCH, extent=(RES,) * 3)

    def feats(grid, c):
        return (torch.randn(grid.capacity, c, generator=g, device=dev) *
                grid.valid[:, None])

    def kern(spec, cin, cout):
        return torch.randn(spec.volume, cin, cout, generator=g,
                           device=dev) / math.sqrt(spec.volume * cin)
    k3, k3s2 = KS(3, 1, ndim=3), KS(3, 2, ndim=3)
    return [
        ("k3s1_cin1", "k3s1", feats(g1, 1), kern(k3, 1, 32), g1, g1, k3),
        ("k3s1_cin4", "k3s1", feats(g8, 4), kern(k3, 4, 4), g8, g8, k3),
        ("k3s2_strided", "k3s2", feats(g1, 1), kern(k3s2, 1, 32), g1, g2,
         k3s2),
        ("k2s2_pinned_transpose", "k2s2T", feats(g2, 32), kern(s8, 32, 32),
         g2, g1, s8),
        ("k2s2_generative", "k2s2G", feats(g8, 512), kern(s8, 512, 512), g8,
         g4_grown, s8),
        ("k3s1_960", "k3s1", feats(g16, 960), kern(k3, 960, 960), g16, g16,
         k3),
        ("empty_grid", "k3s1", torch.zeros(1024, 16, device=dev),
         kern(k3, 16, 16), empty, empty, k3),
    ]


def tiny_reference(mp, dev) -> dict:
    """A tiny configuration on the card and on the CPU, with the same
    weights, inputs and noise.  The CPU runs the plain versions under the
    card's compute policy (bf16 conv operands, float32 accumulation), so
    the two differ in summation order only.  Each stage gets the same input
    on both sides:

    - the encoder's latent: max|Δ| ≤ 1e-2·max|ref|;
    - the decoded voxel set of one sampled latent: IoU ≥ 0.95;
    - one UNet forward on N(0,1) features: ‖Δ‖ ≤ 0.25·‖ref‖.  This random
      tiny UNet is chaotic under bf16: a one-ulp flip of a bf16 operand
      grows several-fold per block at its coarse levels, where an instance
      holds few voxels, and the CPU alone, reordering only the sum of its
      conv GEMMs, drifts by up to 0.1 of ‖ref‖ at the output.  So this
      check catches layout and routing faults (errors of order one), not
      rounding.
    """
    import torch
    b, res, cap, steps, scale = 2, 128, 4096, 3, 0.1428
    kw = dict(input_capacity=cap, batch_size=b, vae_channel=(8, 16, 32, 32,
                                                             4),
              unet_channel=(4, 8, 16, 16), group=4)
    vae_c, unet_c = mp.serve.generation_models(device="cpu", seed=3, **kw)
    vae_g, unet_g = mp.serve.generation_models(device=dev, seed=3, **kw)
    vae_g.load_state_dict(vae_c.state_dict())
    unet_g.load_state_dict(unet_c.state_dict())
    ds = mp.data.SyntheticShapes(resolution=res, num_samples=b,
                                 points_per_shape=1500)
    cpad, valid, _, _ = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(b)], cap)
    shape = (mp.serve.capacities(cap)[0][2], 4)
    g = torch.Generator().manual_seed(5)
    x_unet = torch.randn(shape, generator=g)
    noise = torch.randn(shape, generator=g)
    sched = mp.diffusion.DDIMScheduler.create()
    z = []  # one sampled latent (the CPU's), decoded on both sides

    @torch.no_grad()
    def side(vae, unet, d):
        st = mp.sparse_tensor(
            torch.as_tensor(cpad, device=d),
            torch.as_tensor(valid, device=d)[:, None].float(), capacity=cap,
            batch_size=b, valid=torch.as_tensor(valid, device=d),
            extent=(res,) * 3)
        mean, _ = vae.encode(st)
        t = torch.tensor([600, 40], dtype=torch.int32, device=d)
        u = unet(mean.with_features(x_unet.to(d) * mean.valid[:, None]), t)
        if not z:
            z.append(mp.diffusion.sample_latent(
                unet, sched, mean.with_features(mean.features * scale),
                num_inference_steps=steps, init_noise=noise).features)
        _, _, sout = vae.decode(mean.with_features(z[0].to(d) / scale),
                                st.grid)
        fn = mp.serve.build_generate_fn(
            vae, unet, sched, input_capacity=cap, batch_size=b,
            resolution=res, vae_scale=scale, sample_steps=steps, device=d)
        coords, v = fn(cpad, valid, init_noise=noise.to(d))
        return (mean.features.cpu(), u.features.cpu(),
                voxel_set(sout.grid.coords, sout.grid.valid),
                voxel_set(coords, v))

    mp.ops.set_default_compute_dtype(torch.bfloat16)
    try:
        got = {"cpu": side(vae_c, unet_c, torch.device("cpu")),
               "gpu": side(vae_g, unet_g, dev)}
    finally:
        mp.ops.set_default_compute_dtype(None)
    c, gp = got["cpu"], got["gpu"]
    rel = [float((gp[i] - c[i]).abs().max() / c[i].abs().max())
           for i in (0, 1)]
    unet_rms = float((gp[1] - c[1]).norm() / c[1].norm())
    iou = [len(c[i] & gp[i]) / max(len(c[i] | gp[i]), 1) for i in (2, 3)]
    rec = {"tiny_reference": True, "vs": "cpu, same bf16 policy",
           "latent_rel_err": rel[0], "unet_rel_err": rel[1],
           "unet_rms_rel_err": unet_rms,
           "decode_voxels_cpu": len(c[2]), "decode_voxels_gpu": len(gp[2]),
           "decode_voxel_iou": iou[0], "generate_voxel_iou": iou[1],
           "ok": bool(rel[0] <= 1e-2 and unet_rms <= 0.25 and
                      iou[0] >= 0.95 and len(c[2]) > 0)}
    emit(rec)
    return rec


def voxel_set(coords, valid) -> set:
    return {tuple(r) for r in coords[valid].cpu().tolist()}


def totals(per_key, recs) -> dict:
    """Sum over a path's launches (``per_key``: launch shape → count per
    request or step) of each shape's measured times and bound (``recs``:
    launch shape → its check's record)."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0.0,
           "bytes": 0.0, "library_ms": 0.0}
    for key, count in per_key.items():
        c = recs[key]
        for out, field in (("ms", "ms"), ("plain_ms", "plain_ms"),
                           ("bound_ms", "bound_ms"), ("ops", "bound_ops_ms"),
                           ("bytes", "bound_bytes_ms")):
            tot[out] += count * c[field]
        if tot["library_ms"] is not None and c["library_ms"] is not None:
            tot["library_ms"] += count * c["library_ms"]
        else:
            tot["library_ms"] = None
    return tot


def by_shape(hist) -> Counter:
    """A ``histogram``'s counts by launch shape (N_out, Cin, Cout, K)."""
    out = Counter()
    for key, count in hist.items():
        out[key[:4]] += count
    return out


def histogram(routes, keep) -> Counter:
    return Counter((r.n_out, r.cin, r.cout, r.k, r.layer) for r in routes
                   if keep(r))


def emit_histogram(label, hist) -> None:
    emit({label: [{"n_out": k[0], "cin": k[1], "cout": k[2], "k": k[3],
                   "kind": k[4], "count": c}
                  for k, c in sorted(hist.items())]})


def counters(mp) -> dict:
    return {name: getattr(getattr(mp.ops, module), wrapper)
            for name, (module, wrapper, _, _) in KERNELS.items()}


def expected_launches(routes) -> dict:
    """Each kernel's launches that ``routes`` call for: B1 (B5) for every
    fused-route (brick-route) conv, B3 (B6) where its kernel is trained,
    B2 (the dF pass) where its input carries a gradient."""
    out = {}
    for names, branch in ((FUSED, "fused"), (BRICK, "brick")):
        rs = [r for r in routes if r.branch == branch]
        out.update(zip(names, (len(rs), sum(r.grad_in for r in rs),
                               sum(r.grad_w for r in rs))))
    return out


def train_phase(mp, dev, cap):
    """10 steps of `examples/train_vae.py`'s default configuration through
    ``train.make_train_step``, on one fixed batch of 4 synthetic shapes;
    ``cap`` keeps step 1's B1, B2 and B3 operands.  Before them, step 1's
    loss and gradients with the brick gate off and on (``gate_compare``,
    the running statistics restored after each), which also keeps the
    brick kernels' operands at the VAE's widths.

    Unclamped (``max_keep`` None), as train_vae.py runs.  No clamp could
    make the decoder's levels fit their buffers here: training force-keeps
    the target voxels, and at level 0 those are the whole stride-8 latent
    grid (3686 rows for this batch), whose 8x growth (29488 candidates)
    already exceeds the 16384-row level-1 buffer.  An overflowing buffer
    keeps the lowest keys, as in the JAX package; ``decoder_levels`` shows
    it per step.

    Training must make progress: the reconstruction term (BCE) of the
    last step must be below step 1's, and the loss must fall at every step
    after its peak, which comes before the last step.  The total loss of
    step 10 is not below step 1's: Adam's first step at lr 1e-3 moves every
    weight by ~1e-3, which on the 512-wide encoder sends the max of the
    latent's log-variance (``log_var_max``) from ~7 to ~52, so step 2's KLD
    is ~4e18 (loss ~4e12), and the loss then falls about 2x per step.  The
    JAX package's own steps do the same: at these widths on a quarter of
    the input, on the CPU in float32 (`tests/vae_steps_vs_jax.py`), its
    log-variance max goes 5.3, 14.1, 39.1 over steps 1-3 (KLD 4.5e13 at
    step 3), and the port's plain versions, from the same weights and
    noise, follow it within 0.3% of the loss for 8 steps: the spike belongs
    to the configuration, not to the kernels.  Returns (ok, step
    records, routes of step 1, launches over the path, a callable that runs
    one more step, the gate comparison's record and routes)."""
    import torch
    from mink_octtree_stablediffusion_tpu_torch.train import vae as tv
    enc, dec = mp.serve.capacities(CAP)
    t0 = time.perf_counter()
    vae = mp.models.VAE(channels=VAE_CH, encoder_capacities=enc,
                        decoder_capacities=dec, device=dev, seed=0)
    state = mp.train.TrainState(vae, mp.train.vae_optimizer(
        vae.parameters(), TRAIN_LR))
    loss_fn = tv.build_loss_fn(
        input_capacity=CAP, batch_size=BATCH, resolution=RES,
        kld_weight=TRAIN_KLD, device=dev)
    step = mp.train.make_train_step(loss_fn)
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=256)
    batch = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(BATCH)], CAP, 200_000)[:3]
    gen = torch.Generator(device=dev).manual_seed(0)
    emit({"train_model_built_s": time.perf_counter() - t0,
          "vae_params": sum(p.numel() for p in vae.parameters()),
          "input_voxels": int(batch[1].sum()), "max_keep": None})
    stats = {n: b.clone() for n, b in vae.named_buffers()}

    def restore():
        with torch.no_grad():
            for n, b in vae.named_buffers():
                b.copy_(stats[n])

    eps = torch.randn((enc[2], VAE_CH[4]), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    vae.train()
    compare = gate_compare(mp, "vae", vae, lambda perturb: loss_fn(
        vae, batch, eps=eps.bfloat16().float() if perturb else eps), cap,
        restore)
    outputs = []  # (out_clss, mean, log_var) of each forward
    hook = vae.register_forward_hook(
        lambda m, i, o: outputs.append((o[0], o[3], o[4])))
    count = counters(mp)
    steps, first_routes, ok = [], None, True
    for c in count.values():
        c.launches = 0  # counts from here on are the train path's
    for i in range(TRAIN_STEPS):
        cap.at("vae_train", FUSED if i == 0 else ())
        before = {n: c.launches for n, c in count.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mp.nn.record_routes() as routes:
            loss, aux = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {n: c.launches - before[n] for n, c in count.items()}
        fused = [r for r in routes if r.branch == "fused"]
        missing = [n for n, p in vae.named_parameters() if p.grad is None]
        finite = bool(torch.stack(
            [torch.isfinite(loss)] +
            [torch.isfinite(p.grad).all() for p in vae.parameters()
             if p.grad is not None]).all().item())
        out_clss, mean, log_var = outputs.pop()
        rec = {"train_step": i + 1, "wall_s": wall, "loss": float(loss),
               "bce": float(aux["bce"]), "kld": float(aux["kld"]),
               "log_var_max": float(
                   log_var.features.detach()[mean.valid].max()),
               "decoder_levels": decoder_levels(out_clss, BATCH),
               "fused_route_convs": len(fused),
               "fused_with_input_grad": sum(r.grad_in for r in fused),
               "launches": launched, "convs": len(routes),
               "branches": dict(Counter(r.branch for r in routes)),
               "params_without_grad": missing[:5],
               "all_finite": finite}
        emit(rec)
        steps.append(rec)
        first_routes = first_routes or routes
        ok = ok and finite and not missing and (
            launched == expected_launches(routes))
    cap.at(None)
    hook.remove()
    totals = {n: c.launches for n, c in count.items()}
    loss = [r["loss"] for r in steps]
    peak = loss.index(max(loss))
    falls = (peak < len(loss) - 1 and
             all(b < a for a, b in zip(loss[peak:], loss[peak + 1:])) and
             steps[-1]["bce"] < steps[0]["bce"])
    emit({"train_path_launches": totals, "loss_step1": loss[0],
          "loss_peak": loss[peak], "peak_step": peak + 1,
          "loss_last": loss[-1], "bce_step1": steps[0]["bce"],
          "bce_last": steps[-1]["bce"], "loss_falls": falls,
          "loss_last_below_step1": loss[-1] < loss[0]})
    return (ok and falls, steps, first_routes, totals,
            lambda: step(state, batch, generator=gen), compare)


def tiny_train_reference(mp, dev) -> dict:
    """One train step of a tiny VAE (widths (8, 16, 32, 32, 4), batch 2,
    resolution 128, 4096 input rows) on the card and on the CPU, with the
    same weights, batch and ``eps``.  The CPU runs the plain versions under
    the card's compute policy (bf16 conv operands, float32 accumulation),
    so the two differ in summation order (and B3's atomics) only:

    - the loss: |Δ| ≤ 1e-2·|ref|;
    - every gradient: relative RMS ‖Δ‖/‖ref‖ ≤ ``TINY_GRAD_RTOL`` (0.075);
    - the step's update of every running statistic (new − old, stricter
      than the new value, whose 0.9·old part is the same on both sides):
      relative RMS ≤ ``TINY_STAT_RTOL`` (0.02).

    Why these bounds: bf16 rounding makes the step sensitive to summation
    order alone.  On the CPU, splitting only the fp32 sum of each conv GEMM
    in two halves moves this step's gradients by a relative RMS of up to
    0.031 (median 0.013) and its statistic updates by up to 0.0039; the
    card measured 0.035 (median 0.018) and 0.0055 (H100 80GB HBM3, 700 W).
    The bounds are about 2.4x and 5x the CPU's own reordering noise; a
    layout or routing fault moves a gradient by a relative RMS of order
    one.
    """
    import torch
    from mink_octtree_stablediffusion_tpu_torch.train import vae as tv
    b, res, cap, ch = 2, 128, 4096, (8, 16, 32, 32, 4)
    enc, dec = mp.serve.capacities(cap)
    sides = [(torch.device("cpu"), mp.models.VAE(
        channels=ch, encoder_capacities=enc, decoder_capacities=dec,
        device="cpu", seed=3))]
    sides.append((dev, mp.models.VAE(
        channels=ch, encoder_capacities=enc, decoder_capacities=dec,
        device=dev, seed=3)))
    sides[1][1].load_state_dict(sides[0][1].state_dict())
    ds = mp.data.SyntheticShapes(resolution=res, num_samples=b,
                                 points_per_shape=1500)
    batch = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(b)], cap)[:3]
    eps = torch.randn((enc[2], ch[4]),
                      generator=torch.Generator().manual_seed(5))
    got = []
    mp.ops.set_default_compute_dtype(torch.bfloat16)
    try:
        for d, vae in sides:
            old = {n: t.clone() for n, t in vae.named_buffers()}
            levels = []
            hook = vae.decoder.register_forward_hook(
                lambda m, i, o: levels.append(decoder_levels(o[0], b)))
            state = mp.train.TrainState(vae, mp.train.vae_optimizer(
                vae.parameters(), TRAIN_LR))
            step = mp.train.make_train_step(tv.build_loss_fn(
                input_capacity=cap, batch_size=b, resolution=res,
                kld_weight=TRAIN_KLD, device=d))
            loss, _ = step(state, batch, eps=eps.to(d))
            hook.remove()
            got.append((float(loss),
                        {n: p.grad.cpu() for n, p in vae.named_parameters()},
                        {n: (t - old[n]).cpu()
                         for n, t in vae.named_buffers()}, levels[0]))
    finally:
        mp.ops.set_default_compute_dtype(None)
    (lc, gc, sc, lvc), (lg, gg, sg, lvg) = got
    grad_rel, stat_rel = rel_rms(gg, gc), rel_rms(sg, sc)
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_s = max(stat_rel, key=stat_rel.get)
    loss_rel = abs(lg - lc) / abs(lc)
    rec = {"tiny_train_reference": True, "vs": "cpu, same bf16 policy",
           "loss_cpu": lc, "loss_gpu": lg, "loss_rel_err": loss_rel,
           "grad_rel_rms_max": grad_rel[worst_g], "grad_worst": worst_g,
           "grad_rel_rms_median": statistics.median(grad_rel.values()),
           "stat_update_rel_rms_max": stat_rel[worst_s],
           "stat_worst": worst_s,
           "stat_update_rel_rms_median": statistics.median(
               stat_rel.values()),
           "decoder_levels_equal": lvc == lvg,
           "tol": {"grad": TINY_GRAD_RTOL, "stat": TINY_STAT_RTOL},
           "ok": bool(loss_rel <= 1e-2 and
                      grad_rel[worst_g] <= TINY_GRAD_RTOL and
                      stat_rel[worst_s] <= TINY_STAT_RTOL)}
    emit(rec)
    return rec


@contextlib.contextmanager
def planted_fault(mp):
    """A layout fault planted in the brick route's backward, to show that
    the checks that hold the route end to end can see one: inside this
    block the dF pass reads the taps in forward order, ``W[k]ᵀ`` for
    ``W[26-k]ᵀ`` (its launcher is handed the kernel flipped)."""
    vc = mp.ops.vol_conv
    launch = vc._launch

    def wrong_taps(volp, kernel, mirror):
        return launch(volp, kernel.flip(0).contiguous() if mirror else kernel,
                      mirror)
    vc._launch = wrong_taps
    try:
        yield
    finally:
        vc._launch = launch


def gate_compare(mp, label, model, run_loss, cap, restore=None):
    """Step 1 of a path with the brick gate off, then off again on an input
    rounded to bf16 (the control), then on, then on with a fault planted
    in the dF pass (``planted_fault``), from the same weights, batch and
    draws: ``run_loss(perturb)`` gives the (loss, aux) of one forward,
    whose backward fills ``model``'s gradients, with its Gaussian draw
    rounded to bf16 (a relative change of at most 2^-9) where ``perturb``;
    ``restore`` puts back what a forward moves (the VAE's BatchNorm
    statistics).  ``cap`` keeps B1's operands of the gate-off run and the
    brick kernels' of the gate-on run (paths ``<label>_gate_off`` and
    ``<label>_gate_on``).

    The gate moves the convs that ``brick_preferred`` accepts from B1 to
    B5 (and their backward from B2/B3 to the dF pass and B6): the same
    bf16 operands, float32 sums in another order.  Each kernel is held to
    its plain version within 1e-3 of max|ref| elsewhere in this script;
    here the question is whether the route changes the step beyond that
    rounding, which bf16 re-rounding amplifies downstream.  The control
    measures that amplification in the same run: how far the gradients
    move when nothing but the input's rounding changes.  Bounds
    (``GATE_TOL[label]``): the loss relative, the gradients' relative RMS
    at the median tensor and at the worst.  The diffusion UNet amplifies
    rounding more than the VAE (its instance norms over the few voxels of
    the coarse levels), so its median bound is wider.  The planted fault
    must fail the same bounds (``fault_detected``), or they are too wide
    to see a layout fault in the brick route's backward."""
    import torch
    got = {}
    for name, gate, perturb in (("off", False, False),
                                ("control", False, True),
                                ("on", True, False),
                                ("fault", True, False)):
        mp.ops.enable_brick_conv(gate)
        if name in ("off", "on"):
            cap.at(f"{label}_gate_{name}", BRICK if gate else ("B1",))
        model.zero_grad(set_to_none=True)
        try:
            with contextlib.ExitStack() as stack:
                if name == "fault":
                    stack.enter_context(planted_fault(mp))
                routes = stack.enter_context(mp.nn.record_routes())
                loss, _ = run_loss(perturb)
                loss.backward()
            torch.cuda.synchronize()
        finally:
            cap.at(None)
            mp.ops.enable_brick_conv(False)
        got[name] = (float(loss), {n: p.grad.detach().clone()
                                   for n, p in model.named_parameters()
                                   if p.grad is not None}, routes)
        if restore is not None:
            restore()
    model.zero_grad(set_to_none=True)
    (l0, g0, r0), (l1, g1, r1) = got["off"], got["on"]
    lc, gc, _ = got["control"]
    tol = GATE_TOL[label]

    def against_off(loss, grads):
        rel = (rel_rms(grads, g0) if set(g0) == set(grads)
               else {"(names differ)": 1e9})
        worst = max(rel, key=rel.get)
        return {"loss_rel_err": abs(loss - l0) / abs(l0),
                "grad_rel_rms_median": statistics.median(rel.values()),
                "grad_rel_rms_max": rel[worst], "grad_worst": worst}

    def holds(d):
        return (d["loss_rel_err"] <= tol["loss"] and
                d["grad_rel_rms_median"] <= tol["grad_median"] and
                d["grad_rel_rms_max"] <= tol["grad_max"])
    on, control = against_off(l1, g1), against_off(lc, gc)
    fault = against_off(*got["fault"][:2])
    brick = [r for r in r1 if r.branch == "brick"]
    rec = {"gate_compare": label, "loss_gate_off": l0, "loss_gate_on": l1,
           **on, **{"control_" + k: v for k, v in control.items()},
           **{"fault_" + k: v for k, v in fault.items()},
           "fault_detected": not holds(fault),
           "params_with_grad": len(g0),
           "branches_gate_off": dict(Counter(r.branch for r in r0)),
           "branches_gate_on": dict(Counter(r.branch for r in r1)),
           "tol": tol,
           "ok": bool(brick and len(g0) == sum(
               1 for _ in model.parameters() if _.requires_grad) and
               holds(on) and not holds(fault))}
    emit(rec)
    del got
    return rec, r0, r1


def b5_vs_b1(cap, label, routes_off, routes_on) -> list:
    """(B5 launch shape, B1 launch shape, layer) of each brick-route conv of
    ``gate_compare``'s step, the same conv's route with the gate off."""
    order = iter(cap.b5_order.get(f"{label}_gate_on", []))
    pairs = []
    for off, on in zip(routes_off, routes_on):
        if on.branch == "brick":
            b5 = next(order)
            if off.branch == "fused":
                pairs.append((b5, (off.n_out, off.cin, off.cout, off.k),
                              on.layer))
    return pairs


def diffusion_phase(mp, dev, cap) -> dict:
    """`examples/train_diffusion.py`'s default configuration through
    ``train.diffusion.setup`` with the brick gate on, for ``DIFF_STEPS``
    steps on one fixed batch with one (timesteps, noise) draw and the
    warmup cut to 1 step (``DIFF_FLAGS``).  Before them, step 1 with the
    gate off and on (``gate_compare``).  ``cap`` keeps step 1's operands of
    every kernel.  Returns the step records, step 1's routes, the path's
    launches, the gate comparison, the peak memory and the run."""
    import torch
    from mink_octtree_stablediffusion_tpu_torch.train import diffusion as td
    cfg = td.parse_args(DIFF_FLAGS)
    t0 = time.perf_counter()
    run = td.setup(cfg, dev)
    torch.cuda.synchronize()
    ds = mp.data.SyntheticShapes(resolution=cfg.resolution, num_samples=256)
    cpad, valid, _, _ = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(cfg.batch_size)],
        cfg.input_capacity, cfg.max_batch_len)
    batch = (cpad, valid)
    g = torch.Generator(device=dev).manual_seed(0)
    t = torch.randint(0, cfg.ddpm_num_steps, (cfg.batch_size,), generator=g,
                      device=dev, dtype=torch.int32)
    noise = torch.randn((mp.serve.capacities(cfg.input_capacity)[0][2],
                         cfg.unet_channel[0]), generator=g, device=dev)
    model, opt = run.model, run.state.optimizer
    emit({"diffusion_model_built_s": time.perf_counter() - t0,
          "unet_params": sum(p.numel() for p in run.unet.parameters()),
          "nll_params": sum(p.numel() for p in model["nll"].parameters()),
          "input_voxels": int(valid.sum()), "timesteps": t.tolist(),
          "flags": DIFF_FLAGS})
    model.train()
    compare = gate_compare(
        mp, "diffusion", model, lambda perturb: run.loss_fn(
            model, batch, timesteps=t,
            noise=noise.bfloat16().float() if perturb else noise), cap)
    schedule = mp.train.warmup_cosine(cfg.lr, cfg.warmup, cfg.total_steps)
    count = counters(mp)
    steps, first_routes, ok = [], None, True
    torch.cuda.reset_peak_memory_stats()
    mp.ops.enable_brick_conv(True)
    for c in count.values():
        c.launches = 0  # counts from here on are the diffusion path's
    try:
        for i in range(DIFF_STEPS):
            cap.at("diffusion", KERNELS if i == 0 else ())
            before = {n: c.launches for n, c in count.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mp.nn.record_routes() as routes:
                loss, aux = run.step_fn(run.state, batch, timesteps=t,
                                        noise=noise)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {n: c.launches - before[n] for n, c in count.items()}
            missing = [n for n, p in model.named_parameters()
                       if p.grad is None]
            finite = bool(torch.stack(
                [torch.isfinite(loss)] +
                [torch.isfinite(p.grad).all() for p in model.parameters()
                 if p.grad is not None]).all().item())
            lr = opt.param_groups[0]["lr"]
            rec = {"diffusion_step": i + 1, "wall_s": wall,
                   "loss": float(loss),
                   "denoise_loss": float(aux["denoise_loss"]),
                   "nll_loss": float(aux["nll_loss"]), "lr": lr,
                   "lr_schedule": schedule(i), "launches": launched,
                   "expected_launches": expected_launches(routes),
                   "convs": len(routes),
                   "branches": dict(Counter(r.branch for r in routes)),
                   "params_without_grad": missing[:5], "all_finite": finite}
            emit(rec)
            steps.append(rec)
            first_routes = first_routes or routes
            ok = ok and finite and not missing and lr == schedule(i) and (
                launched == rec["expected_launches"])
    finally:
        cap.at(None)
        mp.ops.enable_brick_conv(False)
    peak = torch.cuda.max_memory_allocated()
    totals = {n: c.launches for n, c in count.items()}
    den = [r["denoise_loss"] for r in steps]
    emit({"diffusion_path_launches": totals, "denoise_step1": den[0],
          "denoise_last": den[-1], "denoise_falls": den[-1] < den[0],
          "peak_memory_bytes": peak,
          "wall_s_steps_2_on": [r["wall_s"] for r in steps[1:]]})

    def one_more_step():
        mp.ops.enable_brick_conv(True)
        try:
            return run.step_fn(run.state, batch, timesteps=t, noise=noise)
        finally:
            mp.ops.enable_brick_conv(False)

    return {"ok": ok and den[-1] < den[0] and all(totals.values()),
            "steps": steps, "routes": first_routes, "launches": totals,
            "compare": compare, "peak_memory_bytes": peak,
            "one_more_step": one_more_step}


def tiny_diffusion_reference(mp, dev) -> dict:
    """One diffusion train step (``train.diffusion.setup`` at widths VAE (8,
    16, 32, 32, 4), UNet (4, 64, 64, 64), group 32, batch 2 of 6000-point
    shapes, resolution 128, 16384 input rows; every UNet width is ≤ 128,
    so the brick gate routes its level-0 k3s1 convs, forward and backward)
    with the same weights, batch, timesteps and noise, under the card's
    compute policy (bf16 conv operands, float32 accumulation), six times:
    on the CPU (where the gate routes nothing: the plain fused-route
    versions) with the noise as drawn and rounded to bf16 (the CPU
    control), and on the card with the gate off, off on the rounded noise
    (the card control), on, and on with a fault planted in the dF pass
    (``planted_fault``).  Held:

    - the frozen encoder's latent, card vs CPU: max|Δ| ≤ 1e-2·max|ref|;
    - the loss, card (gate on) vs CPU: |Δ| ≤ ``TINY_DIFF_LOSS_RTOL``·|ref|;
    - the NLL's gradients (μ, Σ: no conv below them), card vs CPU:
      relative RMS ≤ 1e-4;
    - the UNet's gradients, at the median tensor's relative RMS: card
      gate on vs gate off within ``TINY_DIFF_RATIO`` times the card
      control's, and card (gate on) vs CPU within ``TINY_DIFF_RATIO``
      times the CPU control's;
    - every gradient finite, on the same parameters;
    - the planted fault fails the gate-on vs gate-off bound.

    Why relative to a control: bf16 re-rounding in a random UNet moves
    the gradients by far more than the kernels' own rounding, and how far
    depends on the widths and the voxel counts (at UNet (4, 8, 16, 16) on
    1500-point shapes the CPU control moved them by 0.38 at the median).
    At these widths the controls move them by about a tenth, and a layout
    fault in the brick route's backward moves them by order one.
    """
    import torch
    from mink_octtree_stablediffusion_tpu_torch.train import diffusion as td
    cfg = td.parse_args(["--input_capacity", "16384", "--batch_size", "2",
                         "--vae_channel", "8", "16", "32", "32", "4",
                         "--unet_channel", "4", "64", "64", "64",
                         "--group", "32", "--seed", "3"])
    runs = [td.setup(cfg, "cpu"), td.setup(cfg, dev)]
    runs[1].model.load_state_dict(runs[0].model.state_dict())
    runs[1].vae.load_state_dict(runs[0].vae.state_dict())
    ds = mp.data.SyntheticShapes(resolution=cfg.resolution, num_samples=2,
                                 points_per_shape=6000)
    cpad, valid, _, _ = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(2)], cfg.input_capacity)
    t = torch.tensor([600, 40], dtype=torch.int32)
    noise = torch.randn((mp.serve.capacities(cfg.input_capacity)[0][2], 4),
                        generator=torch.Generator().manual_seed(5))
    rounded = noise.bfloat16().float()
    got = {}
    mp.ops.set_default_compute_dtype(torch.bfloat16)
    try:
        for name, run, nz, gate in (("cpu", runs[0], noise, True),
                                    ("cpu_control", runs[0], rounded, True),
                                    ("off", runs[1], noise, False),
                                    ("control", runs[1], rounded, False),
                                    ("on", runs[1], noise, True),
                                    ("fault", runs[1], noise, True)):
            d = run.device
            mp.ops.enable_brick_conv(gate)
            st = mp.sparse_tensor(
                torch.as_tensor(cpad, device=d),
                torch.as_tensor(valid, device=d)[:, None].float(),
                capacity=cfg.input_capacity, batch_size=2,
                valid=torch.as_tensor(valid, device=d),
                extent=(cfg.resolution,) * 3)
            with torch.no_grad():
                latent = run.vae.eval().encode(st)[0].features.cpu()
            run.model.train()
            run.model.zero_grad(set_to_none=True)
            with contextlib.ExitStack() as stack:
                if name == "fault":
                    stack.enter_context(planted_fault(mp))
                routes = stack.enter_context(mp.nn.record_routes())
                loss, _ = run.loss_fn(run.model, (cpad, valid),
                                      timesteps=t.to(d), noise=nz.to(d))
                loss.backward()
            got[name] = (loss.item(), {n: p.grad.cpu() for n, p in
                                       run.model.named_parameters()},
                         Counter(r.branch for r in routes), latent)
    finally:
        mp.ops.set_default_compute_dtype(None)
        mp.ops.enable_brick_conv(False)
    lc, gc, bc, zc = got["cpu"]
    lg, gg, bg, zg = got["on"]

    def unet_median(a, ref):
        rel = rel_rms({n: v for n, v in a.items() if n.startswith("unet.")},
                      {n: v for n, v in ref.items() if n.startswith("unet.")})
        return statistics.median(rel.values())
    off = got["off"][1]
    med = {"on_vs_off": unet_median(gg, off),
           "card_control": unet_median(got["control"][1], off),
           "fault_vs_off": unet_median(got["fault"][1], off),
           "on_vs_cpu": unet_median(gg, gc),
           "off_vs_cpu": unet_median(off, gc),
           "cpu_control": unet_median(got["cpu_control"][1], gc)}
    rel = rel_rms(gg, gc)
    worst = max(rel, key=rel.get)
    nll = max(v for n, v in rel.items() if n.startswith("nll."))
    latent_rel = float((zg - zc).abs().max() / zc.abs().max())
    loss_rel = abs(lg - lc) / abs(lc)
    finite = all(bool(torch.isfinite(g).all()) for g in gg.values())
    gate_holds = med["on_vs_off"] <= TINY_DIFF_RATIO * med["card_control"]
    fault_detected = (med["fault_vs_off"] >
                      TINY_DIFF_RATIO * med["card_control"])
    rec = {"tiny_diffusion_reference": True,
           "vs": "cpu (fused route) and the card with the gate off, same "
                 "bf16 policy",
           "latent_rel_err": latent_rel, "loss_cpu": lc, "loss_gpu": lg,
           "loss_rel_err": loss_rel,
           "loss_gate_off_rel_err": abs(got["off"][0] - lg) / abs(lg),
           "nll_grad_rel_rms_max": nll,
           "unet_grad_rel_rms_median": med,
           "grad_rel_rms_max_vs_cpu": rel[worst], "grad_worst": worst,
           "fault_detected": fault_detected,
           "branches_cpu": dict(bc), "branches_gpu": dict(bg),
           "branches_gpu_gate_off": dict(got["off"][2]),
           "tol": {"latent": 1e-2, "loss": TINY_DIFF_LOSS_RTOL,
                   "nll_grad": 1e-4, "unet_grad_vs_control": TINY_DIFF_RATIO},
           "ok": bool(bg.get("brick", 0) > 0 and finite and
                      set(gg) == set(gc) and latent_rel <= 1e-2 and
                      loss_rel <= TINY_DIFF_LOSS_RTOL and nll <= 1e-4 and
                      gate_holds and fault_detected and
                      med["on_vs_cpu"] <= TINY_DIFF_RATIO *
                      med["cpu_control"])}
    emit(rec)
    return rec


def map_conv_bytes(w, f) -> int:
    """B4's and B7's bytes on workload ``w`` with features ``f``: the map,
    the features and the float32 weight read once, the output (in the
    features' dtype) written once."""
    k, n_out = w.nbr.shape
    return (4 * k * n_out + f.element_size() * f.numel() +
            4 * w.kernel.numel() + f.element_size() * n_out *
            w.kernel.shape[2])


def check_map_conv(mp, kernel, w, dtype=None):
    """B4 (bf16 operands) or B7 (float32-accurate products) on workload
    ``w``, its features in ``dtype`` (default: as built, float32), against
    its plain version on the card: B4's in bf16, B7's in float32 (so B7 on
    bf16 features is held against the bf16 features times the float32
    weight).  B7 on float32 features is held at a float32 limit,
    ``B7_F32_RTOL``·max|ref|; B4 at 1e-3·max|ref| + 1e-5; B7's bf16 output
    at one bf16 ulp of max|ref| + 1e-5 (``timed_check``'s ``bf16_out``).
    Two launches must give the same output bit for bit, and the profiler
    must read a device time (``device_ms``).  Bounds: at the bf16 peak
    (``bound_ms``), with B7's products as the kernel forms them on the
    tensor cores (``bound_split_ms``: 3 bf16 products on bf16 features, 6
    on float32) and as float32 FMAs (``bound_fp32_ms``)."""
    import torch
    from mink_octtree_stablediffusion_tpu_torch import bench_conv as bc
    oc, pc = mp.ops.onehot_conv, mp.ops.pallas_conv
    f = w.features if dtype is None else w.features.to(dtype)
    k, nbr = w.kernel, w.nbr
    cin, cout = k.shape[1], k.shape[2]
    if kernel == "B4":
        run = lambda: oc.onehot_sparse_conv(f, k, nbr)  # noqa: E731
        plain = lambda: oc.map_conv_plain(  # noqa: E731
            f, k, nbr, torch.bfloat16)
        tols = {}
    else:
        run = lambda: pc.pallas_sparse_conv(f, k, nbr)  # noqa: E731
        plain = lambda: oc.map_conv_plain(  # noqa: E731
            f, k, nbr, torch.float32)
        tols = ({"rel_tol": B7_F32_RTOL, "abs_tol": 0.0, "min_ref": 1e-2}
                if f.dtype == torch.float32 else {"bf16_out": True})
    same = bool(torch.equal(run(), run()))
    dev_ms = bc.device_ms(run)
    source = oc.SOURCES[kernel == "B7"]
    ta, tb = oc.MAP_TERMS[source][f.dtype]
    products = sum(a + b <= 2 for a in range(ta) for b in range(tb))
    nbytes = map_conv_bytes(w, f)
    rec = timed_check(
        kernel, w.name, "k3s1", run, plain, w.pairs, cin, cout, nbytes,
        fp32_flops=kernel == "B7", extra_ok=same and dev_ms > 0,
        n_out=nbr.shape[1], n_in=f.shape[0], k=nbr.shape[0],
        dtype=str(f.dtype), terms=[ta, tb], products=products,
        tile=list(oc.map_tile_shape(cin, cout, (ta, tb))),
        groups=-(-nbr.shape[0] // oc.map_groups(nbr.shape[1], cout,
                                                 nbr.shape[0])),
        bound_split_ms=max(products * 2.0 * w.pairs * cin * cout /
                           PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
        device_ms=dev_ms, repeat_bit_identical=same, **tols)
    return rec


# the passes of B4's and B7's design (csrc/map_conv.cuh), by kernel name
MAP_PASSES = {"cast": "cast_kernel", "count": "count_kernel",
              "scan": "scan_kernel", "compaction": "compact_kernel",
              "gemm": "gemm_kernel<", "reduce": "reduce_kernel"}


def map_pass_table(mp, kernel, w) -> dict:
    """The passes of B4 or B7 (float32 features) on workload ``w``: each
    pass's device ms per call (the profiler), and the CUDA-event ms of the
    launch run up to each stage (``cast``, ``pairs``: through the
    compaction, ``full``)."""
    from mink_octtree_stablediffusion_tpu_torch import bench_conv as bc
    oc = mp.ops.onehot_conv
    source = oc.SOURCES[kernel == "B7"]
    f, k, nbr = w.features, w.kernel, w.nbr

    def run(stage="full"):
        return oc._run_map_conv(source, f, k, nbr, stage)[0]
    through = {s: bc.cuda_time_ms(lambda s=s: run(s)) for s in oc.MAP_STAGES}
    by_name = bc.device_ms_by_kernel(run)
    passes = {p: sum(ms for n, ms in by_name.items() if "map_conv::" + kn in n)
              for p, kn in MAP_PASSES.items()}
    terms = oc.MAP_TERMS[source][f.dtype]
    kv, n_out = nbr.shape
    rec = {"map_pass_table": kernel, "workload": w.name,
           "matched_pairs": w.pairs, "terms": list(terms),
           "tile": list(oc.map_tile_shape(k.shape[1], k.shape[2], terms)),
           "groups": -(-kv // oc.map_groups(n_out, k.shape[2], kv)),
           "device_ms": passes, "device_ms_sum": sum(passes.values()),
           "other_device_ms": sum(ms for n, ms in by_name.items()
                                  if "map_conv::" not in n),
           "profiler_records_lost": bc.profiled.lost,
           "profiler_sessions_refused": bc.profiled.refused,
           "ms_through_stage": through,
           "ok": all(ms > 0 for ms in passes.values())}
    if not rec["ok"]:
        rec["error"] = ("the profiler read 0 device ms for a pass of a "
                        "launch that ran it")
    emit(rec)
    return rec


def check_stage(mp, kernel, w, stage, b1_out):
    """One stage of B1 (B8 on the room, B9 on the finest level) against its
    plain version on the bf16-rounded operands; ``empty`` and ``search``
    must also be exact, ``full`` equal to B1's output (``b1_out``) bit for
    bit.  Bytes: each stage's reads and writes, cumulatively: the output;
    + the input keys and the output coordinates and valid mask
    (``search``); + the features (``gather``); + the weight (``full``).
    Operations: none counted for ``empty`` and ``search``, the float32 adds
    of ``gather`` (matched pairs × min(Cin, Cout)), B1's GEMM for
    ``full``."""
    import torch
    fc = mp.ops.fused_conv
    f, k, g, spec = w.features, w.kernel, w.grid, mp.ops.KernelSpec(3, 1,
                                                                   ndim=3)
    (n_in, cin), cout, n_out = f.shape, k.shape[2], g.capacity
    offs, s_in, cells = fc.conv_geometry(g, spec)
    plain_ops = (f.bfloat16().float(), k.bfloat16().float(), g.flat_keys(),
                 g.coords, g.valid, offs, s_in, cells, torch.float32, stage)
    out = fc.fused_conv_stage(f, k, g, g, spec, stage)
    exact = bool(torch.equal(out, b1_out) if stage == "full" else
                 torch.equal(out, fc._stage_plain(*plain_ops))
                 if stage in ("empty", "search") else True)
    del out
    rank = ("empty", "search", "gather", "full").index(stage)
    nbytes = 4 * n_out * cout + sum(
        (4 * n_in + 17 * n_out, 4 * f.numel(), 4 * k.numel())[:rank])
    flops = {"empty": 0.0, "search": 0.0,
             "gather": float(w.pairs * min(cin, cout)), "full": None}[stage]
    rec = timed_check(
        kernel, w.name, stage,
        lambda: fc.fused_conv_stage(f, k, g, g, spec, stage),
        lambda: fc._stage_plain(*plain_ops), w.pairs, cin, cout, nbytes,
        flops=flops, fp32_flops=stage == "gather", exact=exact, n_out=n_out,
        n_in=n_in, k=offs.shape[0])
    rec["ok"] = rec["ok"] and exact
    return rec


def stage_table(mp, key, ops, count) -> dict:
    """B1's stages (the cut that B8/B9 time on the library path) on one
    launch shape of the generation path, ``key`` with the operands ``ops``
    of its first launch and ``count`` launches per request: each stage's
    CUDA-event and profiler device ms, and its output held as
    ``check_stage`` holds it (``empty`` and ``search`` exact, ``gather``
    within 1e-3·max|ref| + 1e-5, ``full`` equal to B1 bit for bit)."""
    import torch
    from mink_octtree_stablediffusion_tpu_torch import bench_conv as bc
    fc = mp.ops.fused_conv
    plain_ops = ((ops[0].bfloat16().float(), ops[1].bfloat16().float()) +
                 tuple(ops[2:]) + (torch.float32,))
    b1 = fc._launch(*ops, torch.bfloat16)
    stages = {}
    for stage in ("empty", "search", "gather", "full"):
        def run(stage=stage):
            return fc._launch(*ops, torch.bfloat16, stage=stage)
        out = run()
        if stage == "full":
            good = bool(torch.equal(out, b1))
        else:
            ref = fc._stage_plain(*plain_ops, stage)
            err = (out - ref).abs().max().item()
            good = bool(torch.equal(out, ref) if stage != "gather" else
                        err <= 1e-3 * ref.abs().max().item() + 1e-5)
            del ref
        del out
        dev_ms = bc.device_ms(run)
        stages[stage] = {"ms": bc.cuda_time_ms(run), "device_ms": dev_ms,
                         "profiler_records_lost": bc.profiled.lost,
                         "profiler_sessions_refused": bc.profiled.refused,
                         "ok": good and dev_ms > 0}
        if dev_ms <= 0:
            stages[stage]["error"] = ("the profiler read 0 device ms for a "
                                      "launch that ran")
    rec = {"b1_stage_table": "generation", "launch_shape": list(key),
           "launches_per_request": count, "stages": stages,
           "ok": all(v["ok"] for v in stages.values())}
    emit(rec)
    return rec


# B3's passes (csrc/fused_sparse_conv_dw.cu), by their kernels' names
B3_PASSES = {"cast": "cast_kernel", "search": "search_kernel",
             "scan": "scan_kernel", "compaction": "compact_kernel",
             "gemm": "gemm_kernel<", "reduce": "reduce_kernel"}


def b3_pass_table(mp, key, ops, count) -> dict:
    """B3's passes on one launch shape of the VAE train path, ``key`` with
    the operands ``ops`` of its first launch (the cotangent at unit RMS)
    and ``count`` launches per step: each pass's device ms per call (cast,
    search, scan, compaction, GEMM, reduce; the profiler), the CUDA-event
    ms of the launch run up to each stage (``cast``, ``pairs``: through
    the compaction, ``full``), the tile and splits, and whether two
    launches give dW bit for bit."""
    import torch
    from mink_octtree_stablediffusion_tpu_torch import bench_conv as bc
    fc = mp.ops.fused_conv
    ops = (ops[0], unit_rms(ops[1])[0]) + tuple(ops[2:])

    def run():
        return fc._launch_dkernel(*ops, torch.bfloat16)
    same = bool(torch.equal(run(), run()))
    through = {"full": bc.cuda_time_ms(run)}
    for stage in fc.DW_STAGES[1:]:
        through[stage] = bc.cuda_time_ms(
            lambda: fc._run_dkernel(*ops, torch.bfloat16, None, stage))
    by_name = bc.device_ms_by_kernel(run)
    passes = {p: sum(ms for n, ms in by_name.items()
                     if "fused_sparse_conv_dw::" + k in n)
              for p, k in B3_PASSES.items()}
    n_out, cin, cout, k = key
    splits = fc.dw_splits(n_out, cin, cout, k)
    ran = [p for p in passes if p != "reduce" or splits > 1]
    rec = {"b3_pass_table": "vae_train", "launch_shape": list(key),
           "launches_per_step": count,
           "tile": list(fc.dw_tile_shape(cin, cout)),
           "splits": splits,
           "device_ms": passes, "device_ms_sum": sum(passes.values()),
           "other_device_ms": sum(ms for n, ms in by_name.items()
                                  if "fused_sparse_conv_dw::" not in n),
           "profiler_records_lost": bc.profiled.lost,
           "profiler_sessions_refused": bc.profiled.refused,
           "ms": through["full"], "ms_through_stage": through,
           "repeat_bit_identical": same,
           "ok": same and all(passes[p] > 0 for p in ran)}
    if not all(passes[p] > 0 for p in ran):
        rec["error"] = ("the profiler read 0 device ms for a pass of a "
                        "launch that ran it")
    emit(rec)
    return rec


# B6's passes (csrc/brick_conv_dw.cu), by their kernels' names
B6_PASSES = {"live": "live_kernel", "gemm": "gemm_kernel",
             "reduce": "reduce_kernel"}


def b6_pass_table(mp, path, key, ops, count, check) -> dict:
    """B6's passes on one launch shape of ``path`` (``key``: the forward
    conv's (B, X, Y, Z, Cin, Cout)), with the operands ``ops`` of its first
    launch (the cotangent at unit RMS) and ``count`` launches per step:
    each pass's device ms per call (live, GEMM, reduce; the profiler), the
    CUDA-event ms of the launch run up to each stage (``live``, ``full``),
    the splits, the live tiles and their share, the occupied pairs' share
    of the dense work, the share of the bound (``check``: the shape's
    ``check_brick_launch`` record, with cuDNN's ms) that the event and the
    device time reach, and whether two launches give dW bit for bit."""
    import torch
    from mink_octtree_stablediffusion_tpu_torch import bench_conv as bc
    vc = mp.ops.vol_conv
    volp, gvolp, cin, cout = ops
    gvolp = unit_rms(gvolp)[0]

    def run():
        return vc._launch_dw(volp, gvolp, cin, cout)
    same = bool(torch.equal(run(), run()))
    through = {"full": bc.cuda_time_ms(run), "live": bc.cuda_time_ms(
        lambda: vc._run_dw(volp, gvolp, cin, cout, None, "live"))}
    by_name = bc.device_ms_by_kernel(run)
    passes = {p: sum(ms for n, ms in by_name.items()
                     if "brick_conv_dw::" + k in n)
              for p, k in B6_PASSES.items()}
    b, x, y, z = key[:4]
    splits = vc.dw_splits(b, x, y, z, cin, cout)
    live = int(vc._launch_dw_live(gvolp, cout).numel())
    tiles = vc.n_tiles(b, x, y, z)
    dev_ms = sum(passes.values())
    ran = [p for p in passes if p != "reduce" or splits > 1]
    rec = {"b6_pass_table": path, "launch_shape": list(key),
           "launches_per_step": count,
           "splits": splits, "tiles": tiles, "live_tiles": live,
           "live_share": live / tiles,
           "occupied_pairs_share": check["matched_pairs"] /
           (27 * check["cells"]),
           "device_ms": passes, "device_ms_sum": dev_ms,
           "other_device_ms": sum(ms for n, ms in by_name.items()
                                  if "brick_conv_dw::" not in n),
           "profiler_records_lost": bc.profiled.lost,
           "profiler_sessions_refused": bc.profiled.refused,
           "ms": through["full"], "ms_through_stage": through,
           "bound_ms": check["bound_ms"], "bound_by": check["bound_by"],
           "dense_ops_ms": check["dense_ops_ms"],
           "bound_share_event": check["bound_ms"] / through["full"],
           "bound_share_device": check["bound_ms"] / dev_ms if dev_ms else 0,
           "plain_ms": check["plain_ms"], "cudnn_ms": check["library_ms"],
           "repeat_bit_identical": same,
           "ok": same and all(passes[p] > 0 for p in ran)}
    if not all(passes[p] > 0 for p in ran):
        rec["error"] = ("the profiler read 0 device ms for a pass of a "
                        "launch that ran it")
    emit(rec)
    return rec


def library_phase(mp, dev, power) -> dict:
    """The library path (`bench_conv`) at full size, seed 0.

    - Builds the room, finest and wide workloads; the room's exact pair
      count (``conv_pair_count``) must equal its map's matched pairs.
    - Drives the path once per workload (``bench_conv.drive``) with the
      launch counts set to 0 just before and read just after: B1, B4, B7
      and B8 must launch on the room, B4, B7 and B9 on the finest level,
      B4 and B7 on the wide case.
    - Holds each kernel against its plain version on the card within
      1e-3·max|ref| + 1e-5 (``timed_check``): B4 and B7 on every workload
      (B7 on float32 features within ``B7_F32_RTOL``, and also on bf16
      features on the wide level; each B4/B7 launch also bit for bit equal
      to a second one, ``check_map_conv``), B1 on the room, every stage of
      B8/B9 (``check_stage``); and B4 and B1 (on bf16-rounded operands)
      and B7 (float32) against the room's ``sparse_conv_apply``
      (``conv_xla``) at the same bound.  Prints B4's and B7's launch table
      (pairs, bounds, event, device and plain ms) and their passes on
      every workload (``map_pass_table``).
    - Holds ``onehot_conv``'s backward on the card (plain PyTorch, a
      unit-RMS cotangent) against the same formula on the CPU, with
      max|ref| ≥ 1e-2.
    - Times `bench_conv.run` (CUDA events, and the device's busy time
      from ``torch.profiler``): the room's pipeline stages, `bench.py`'s
      points/sec on the fused and the kernel-map route, each conv alone,
      and B1's stage attribution.

    Returns ok, the failures, the kernel records by (kernel, "library"),
    and each kernel's launches on the path."""
    import torch
    from mink_octtree_stablediffusion_tpu_torch import bench_conv as bc
    from mink_octtree_stablediffusion_tpu_torch.ops import pallas_conv as pc
    fc, oc = mp.ops.fused_conv, mp.ops.onehot_conv
    failures = []
    t0 = time.perf_counter()
    ws = bc.workloads(dev, seed=0)
    room = ws["room"]
    pair_count = bc.conv_pair_count(
        room.grid.coords[room.grid.valid][:, 1:].cpu().numpy())
    emit({"library_workloads_built_s": time.perf_counter() - t0,
          "workloads": {n: {"rows": w.grid.capacity,
                            "voxels": int(w.grid.valid.sum()),
                            "input_points": w.points,
                            "cin": w.kernel.shape[1],
                            "cout": w.kernel.shape[2],
                            "matched_pairs": w.pairs}
                        for n, w in ws.items()},
          "room_conv_pair_count": pair_count})
    if pair_count != room.pairs:
        failures.append("room pair count")

    wrappers = {"B1": fc.fused_sparse_conv, "B4": oc.onehot_sparse_conv,
                "B7": pc.pallas_sparse_conv, "stages": fc.fused_conv_stage}
    per_workload = {}
    for name, w in ws.items():
        for c in wrappers.values():
            c.launches = 0  # counts from here on are this workload's pass
        bc.drive(w)
        torch.cuda.synchronize()
        per_workload[name] = {k: c.launches for k, c in wrappers.items()}
    launches = {"B1": per_workload["room"]["B1"],
                "B4": sum(p["B4"] for p in per_workload.values()),
                "B7": sum(p["B7"] for p in per_workload.values()),
                "B8": per_workload["room"]["stages"],
                "B9": per_workload["finest"]["stages"]}
    emit({"library_path_launches": per_workload, "per_kernel": launches})
    if not all(launches.values()):
        failures.append("a kernel of the library path did not launch")

    recs = {(n, "library"): {} for n in ("B1", *LIBRARY_KERNELS)}
    for w in ws.values():
        for kernel in ("B4", "B7"):
            recs[(kernel, "library")][w.name] = check_map_conv(mp, kernel, w)
    # B7 on bf16 features (not on the path, which builds float32 ones)
    b7_bf16 = check_map_conv(mp, "B7", ws["wide"], torch.bfloat16)
    rows = [r for n in ("B4", "B7") for r in recs[(n, "library")].values()]
    emit({"map_conv_launch_table": power, "rows": [
        {key: r[key] for key in (
            "kernel", "case", "dtype", "n_out", "cin", "cout",
            "matched_pairs", "terms", "tile", "groups", "bound_ops_ms",
            "bound_bytes_ms", "bound_ms", "bound_split_ms", "bound_fp32_ms",
            "ms", "device_ms", "plain_ms", "max_abs_err", "tol",
            "repeat_bit_identical", "ok") if key in r}
        for r in rows + [b7_bf16]]})
    if not b7_bf16["ok"]:
        failures.append("B7 on bf16 features")
    for w in ws.values():
        for kernel in ("B4", "B7"):
            if not map_pass_table(mp, kernel, w)["ok"]:
                failures.append(f"{kernel} pass table on {w.name}")
    spec = bc.K3
    recs[("B1", "library")]["room"] = check_case(
        mp, "library_room", "k3s1", room.features, room.kernel, room.grid,
        room.grid, spec)
    for kernel, w in (("B8", room), ("B9", ws["finest"])):
        b1_out = fc.fused_sparse_conv(w.features, w.kernel, w.grid, w.grid,
                                      spec)
        for stage in bc.STAGE_ORDER:
            recs[(kernel, "library")][stage] = check_stage(
                mp, kernel, w, stage, b1_out)
        del b1_out
    if not all(r["ok"] for got in recs.values() for r in got.values()):
        failures.append("library kernel checks")

    # B4, B7 and B1 against the room's conv_xla (sparse_conv_apply)
    f, k, nbr = room.features, room.kernel, room.nbr
    xla = {"bf16": mp.ops.sparse_conv_apply(f.bfloat16().float(),
                                            k.bfloat16().float(), nbr),
           "f32": mp.ops.sparse_conv_apply(f, k, nbr)}
    vs = {}
    for name, out, ref in (
            ("B4", oc.onehot_sparse_conv(f, k, nbr), xla["bf16"]),
            ("B7", pc.pallas_sparse_conv(f, k, nbr), xla["f32"]),
            ("B1", fc.fused_sparse_conv(f, k, room.grid, room.grid, spec),
             xla["bf16"])):
        err = (out - ref).abs().max().item()
        tol = (B7_F32_RTOL if name == "B7" else 1e-3) * \
            ref.abs().max().item() + (0.0 if name == "B7" else 1e-5)
        vs[name] = {"max_abs_err": err, "tol": tol, "ok": err <= tol}
    emit({"library_vs_conv_xla": "room", **vs})
    if not all(v["ok"] for v in vs.values()):
        failures.append("library kernels vs conv_xla")

    # onehot_conv's backward on the card against the CPU
    gen = torch.Generator(device=dev).manual_seed(3)
    g, g_rms = unit_rms(torch.randn(nbr.shape[1], k.shape[2], device=dev,
                                    generator=gen) * room.grid.valid[:, None])
    fg, kg = f.clone().requires_grad_(), k.clone().requires_grad_()
    grads = torch.autograd.grad(oc.onehot_conv(fg, kg, nbr), (fg, kg), g)
    ref = oc._xla_backward(f.cpu(), k.cpu(), nbr.cpu(), g.cpu())
    bwd = {}
    for name, got, r in zip(("dF", "dW"), grads, ref):
        err = (got.cpu() - r).abs().max().item()
        ref_max = r.abs().max().item()
        bwd[name] = {"max_abs_err": err, "max_abs_ref": ref_max,
                     "ok": err <= 1e-3 * ref_max + 1e-5 and
                     ref_max >= MIN_REF_GRAD}
    emit({"library_onehot_conv_backward": "room, card vs cpu",
          "g_rms": g_rms, **bwd})
    if not all(v["ok"] for v in bwd.values()):
        failures.append("onehot_conv backward")

    for rec in bc.run(ws, bc.cuda_time_ms, bc.device_ms):
        emit({"card": power, **rec})
    del ws, room, f, k, nbr, xla, fg, kg, grads
    torch.cuda.empty_cache()
    return {"ok": not failures, "failures": failures, "recs": recs,
            "launches": launches}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", action="store_true")
    p.add_argument("--max-keep", type=int, default=MAX_KEEP,
                   help="generation decoder's top-k clamp per level; 0 = "
                   "none")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(HERE))
    try:
        import mink_octtree_stablediffusion_tpu_torch as mp
    except ImportError as e:
        return fail(f"the port package is not beside this script ({e})")
    if HERE not in Path(mp.__file__).resolve().parents:
        return fail("the port package imported is not this checkout's")
    dev = torch.device(DEVICE)
    from mink_octtree_stablediffusion_tpu_torch.bench_conv import card
    power = card()
    failed = []  # the checks that did not hold

    def need(cond, what: str) -> None:
        if not cond:
            failed.append(what)

    # -- build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = mp.utils.cuda_build.build()
    emit({"build_s": time.perf_counter() - t0,
          "ptxas": {src: [ln.strip() for ln in log.splitlines()
                          if "Used" in ln or "spill" in ln]
                    for src, log in logs.items()}})

    # -- path 1: 3 requests of full-width generation --------------------
    t0 = time.perf_counter()
    vae, unet = mp.serve.generation_models(
        input_capacity=CAP, batch_size=BATCH, vae_channel=VAE_CH,
        unet_channel=UNET_CH, group=GROUP, max_keep=args.max_keep or None,
        device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in unet.parameters())
    emit({"models_built_s": time.perf_counter() - t0,
          "unet_params": n_params, "max_keep": args.max_keep or None,
          "vae_params": sum(p.numel() for p in vae.parameters())})
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=64)
    cpad, valid, _, _ = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(BATCH)], CAP)
    fn = mp.serve.build_generate_fn(
        vae, unet, mp.diffusion.DDIMScheduler.create(), input_capacity=CAP,
        batch_size=BATCH, resolution=RES, vae_scale=0.1428,
        sample_steps=STEPS, device=dev)
    finite, decoded = [], []
    hooks = [unet.register_forward_hook(
        lambda m, i, o: finite.append(torch.isfinite(o.features).all())),
        vae.decoder.register_forward_hook(
        lambda m, i, o: decoded.append(o))]
    count = counters(mp)
    kernel = count["B1"]
    requests, per_request_routes = [], []
    cap = LaunchCapture(mp)
    with cap:
        for c in count.values():
            c.launches = 0  # counts from here on are the generation path's
        for seed in (0, 1, 2):
            cap.at("generation", ("B1",) if seed == 0 else ())
            before = kernel.launches
            gen = torch.Generator(device=dev).manual_seed(seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mp.nn.record_routes() as routes:
                coords, v = fn(cpad, valid, generator=gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            per_inst = torch.bincount(coords[v][:, 0].long(),
                                      minlength=BATCH).tolist()
            fused = [r for r in routes if r.branch == "fused"]
            launched = kernel.launches - before
            out_clss, _, sout = decoded.pop()
            finite.append(torch.isfinite(sout.features).all())
            rec = {"request": seed, "wall_s": wall,
                   "voxels_per_instance": per_inst,
                   "decoder_levels": decoder_levels(out_clss, BATCH),
                   "fused_route_convs": len(fused),
                   "kernel_launches": launched,
                   "convs": len(routes),
                   "branches": dict(Counter(r.branch for r in routes))}
            emit(rec)
            requests.append(rec)
            per_request_routes.append(routes)
            need(min(per_inst) > 0, f"request {seed}: an empty instance")
            need(launched == len(fused), f"request {seed}: B1 launches")
        cap.at(None)
        gen_launches = {n: c.launches for n, c in count.items()}
    for h in hooks:
        h.remove()
    all_finite = bool(torch.stack(finite).all().item())
    emit({"generation_path_launches": gen_launches,
          "all_finite": all_finite})
    # generation runs B1 only: no backward, and the brick gate is off
    need(all_finite and gen_launches["B1"] > 0 and
         not any(gen_launches[n] for n in KERNELS if n != "B1"),
         "generation path")
    hist = histogram(per_request_routes[0], lambda r: r.branch == "fused")
    emit_histogram("fused_launch_shapes_per_request", hist)
    emit_histogram("dense_route_shapes_per_request", histogram(
        per_request_routes[0], lambda r: r.branch == "dense"))
    wall_request = statistics.median(r["wall_s"] for r in requests[1:])
    if args.profile:
        gen = torch.Generator(device=dev).manual_seed(9)
        profile_run("one request", lambda: fn(cpad, valid, generator=gen),
                    wall_request)
    del vae, unet, fn, hooks, decoded
    torch.cuda.empty_cache()

    # -- path 2: 10 steps of full-width VAE training --------------------
    with cap:
        (train_ok, steps, train_routes, train_launches, one_more_step,
         (vae_cmp, vae_off, vae_on)) = train_phase(mp, dev, cap)
    need(train_ok, "VAE training path")
    need(vae_cmp["ok"], "VAE gate comparison")
    hist_b3 = histogram(train_routes, lambda r: r.branch == "fused")
    hist_b2 = histogram(train_routes,
                        lambda r: r.branch == "fused" and r.grad_in)
    emit_histogram("train_fused_launch_shapes_per_step", hist_b3)
    if args.profile:
        profile_run("one VAE train step", one_more_step,
                    statistics.median(r["wall_s"] for r in steps[1:]))
    del one_more_step
    torch.cuda.empty_cache()

    # -- path 3: 10 steps of full-width diffusion training --------------
    with cap:
        diff = diffusion_phase(mp, dev, cap)
    diff_cmp, diff_off, diff_on = diff["compare"]
    need(diff["ok"], "diffusion training path")
    need(diff_cmp["ok"], "diffusion gate comparison")
    droutes = diff["routes"]
    emit_histogram("diffusion_fused_launch_shapes_per_step", histogram(
        droutes, lambda r: r.branch == "fused"))
    emit_histogram("diffusion_brick_route_convs_per_step", histogram(
        droutes, lambda r: r.branch == "brick"))
    if args.profile:
        profile_run("one diffusion train step", diff["one_more_step"],
                    statistics.median(r["wall_s"] for r in diff["steps"][1:]))
    del diff["one_more_step"]
    torch.cuda.empty_cache()

    # -- kernels vs plain at their paths' shapes (and B1's extra cases) --
    recs = {}  # (kernel, path) -> {launch shape: record}

    def check_all(kernel, path, check, kinds):
        got = recs.setdefault((kernel, path), {})
        for key, ops in sorted(cap.case(path, kernel).items()):
            got[key] = check(key, ops, kinds.get(key[:4], "?"))
        return got

    def fused_check(kernel, path):
        if kernel == "B3":
            return lambda key, ops, kind: check_dkernel_launch(
                mp, path, kind, ops)
        # a B2 record carries its launch's own shape (N_out = the
        # forward's N_in, Cin and Cout swapped) and the forward's shape
        return lambda key, ops, kind: check_conv_launch(
            mp, kernel, path, kind, ops, transpose_weight=kernel == "B2",
            forward_shape=list(key))

    def brick_check(kernel, path):
        return lambda key, ops, kind: check_brick_launch(
            mp, kernel, path, key, ops)

    kinds = {(r.n_out, r.cin, r.cout, r.k): r.layer
             for rs in (per_request_routes[0], train_routes, droutes,
                        vae_off, diff_off) for r in rs}
    check_all("B1", "generation", fused_check("B1", "main_path"), kinds)
    st = mp.sparse_tensor(torch.as_tensor(cpad, device=dev),
                          torch.as_tensor(valid, device=dev)[:, None].float(),
                          capacity=CAP, batch_size=BATCH,
                          valid=torch.as_tensor(valid, device=dev),
                          extent=(RES,) * 3)
    extras = [check_case(mp, *case) for case in extra_cases(mp, st, dev)]
    for kernel in FUSED:
        check_all(kernel, "vae_train", fused_check(kernel, "train_path"),
                  kinds)
    for kernel in FUSED:
        check_all(kernel, "diffusion", fused_check(kernel, "diffusion_path"),
                  kinds)
    for path in ("diffusion", "vae_gate_on"):
        for kernel in BRICK:
            check_all(kernel, path, brick_check(kernel, path), kinds)
    for path in ("diffusion_gate_off", "vae_gate_off"):
        check_all("B1", path, fused_check("B1", path), kinds)
    all_recs = [r for got in recs.values() for r in got.values()] + extras
    emit({"kernel_checks": len(all_recs),
          "failed": [(r["kernel"], r["case"], r.get("forward_shape"))
                     for r in all_recs if not r["ok"]]})
    need(all(r["ok"] for r in all_recs), "kernel checks")

    # every launch shape of each path was checked
    def shapes(path, kernel):
        return set(cap.counts.get(path, {}).get(kernel, {}))
    for path, kernels in (("generation", ("B1",)),
                          ("vae_train", FUSED),
                          ("diffusion", KERNELS),
                          ("vae_gate_on", BRICK)):
        for kernel in kernels:
            need(shapes(path, kernel) == set(recs[(kernel, path)]),
                 f"{kernel} checked at every launch shape of {path}")

    # per request / step: each launch shape's time x its launches
    per_request = {"B1": by_shape(hist)}
    # every fused-route conv of a VAE step launches B1 and B3
    per_vae_step = {"B1": by_shape(hist_b3), "B2": by_shape(hist_b2),
                    "B3": by_shape(hist_b3)}
    per_diff_step = {n: cap.per_step("diffusion", n, DIFF_STEPS)
                     for n in KERNELS}
    tot = {"B1": totals(per_request["B1"], recs[("B1", "generation")])}
    tot_vae = {n: totals(per_vae_step[n], recs[(n, "vae_train")])
               for n in FUSED}
    tot.update(B2=tot_vae["B2"], B3=tot_vae["B3"])
    emit({"vae_step_kernel_account": {
        n: {"ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"]} for n, t in tot_vae.items()},
        "ms_b1_b2_b3": sum(t["ms"] for t in tot_vae.values())})
    tot_diff = {n: totals(per_diff_step[n], recs[(n, "diffusion")])
                for n in KERNELS}
    emit({"per_diffusion_step": {
        n: {"launch_shapes": [{"shape": list(k), "count": c}
                              for k, c in sorted(per_diff_step[n].items())],
            **tot_diff[n]} for n in KERNELS}})

    # B1's stages on the generation path's two heaviest launch shapes
    gen_recs = recs[("B1", "generation")]
    heavy = sorted(per_request["B1"], reverse=True,
                   key=lambda k: per_request["B1"][k] * gen_recs[k]["ms"])
    try:
        for key in heavy[:2]:
            need(stage_table(mp, key, cap.case("generation", "B1")[key],
                             per_request["B1"][key])["ok"],
                 "B1 stages on the generation path")
    except Exception:
        traceback.print_exc()
        need(False, "B1 stages on the generation path")

    # B3's passes on the VAE step's two heaviest launch shapes
    vae_recs = recs[("B3", "vae_train")]
    heavy = sorted(per_vae_step["B3"], reverse=True,
                   key=lambda k: per_vae_step["B3"][k] * vae_recs[k]["ms"])
    try:
        for key in heavy[:2]:
            need(b3_pass_table(mp, key, cap.case("vae_train", "B3")[key],
                               per_vae_step["B3"][key])["ok"],
                 "B3 passes on the VAE train path")
    except Exception:
        traceback.print_exc()
        need(False, "B3 passes on the VAE train path")

    # B6's passes at every launch shape of the VAE gate-on step and of the
    # diffusion step; its time per step on both
    per_gate_on = cap.per_step("vae_gate_on", "B6", 1)
    tot_gate_on = totals(per_gate_on, recs[("B6", "vae_gate_on")])
    b6_tables = {"vae_gate_on": [], "diffusion": []}
    try:
        for path, per in (("vae_gate_on", per_gate_on),
                          ("diffusion", per_diff_step["B6"])):
            for key in sorted(per, reverse=True):
                rec = b6_pass_table(mp, path, key, cap.case(path, "B6")[key],
                                    per[key], recs[("B6", path)][key])
                b6_tables[path].append(rec)
                need(rec["ok"], f"B6 passes on the {path} path")
    except Exception:
        traceback.print_exc()
        need(False, "B6 passes")

    def table_sums(rows):  # the pass tables' times x launches per step
        return {f"table_{k}_per_step": sum(r[k] * r["launches_per_step"]
                                           for r in rows)
                for k in ("ms", "device_ms_sum")
                if rows and all(k in r for r in rows)}
    emit({"b6_per_step": {
        "vae_gate_on": {**tot_gate_on, "launch_shapes": [
            {"shape": list(k), "count": c}
            for k, c in sorted(per_gate_on.items())],
            **table_sums(b6_tables["vae_gate_on"])},
        "diffusion": {**tot_diff["B6"],
                      **table_sums(b6_tables["diffusion"])}}})

    # B5 against B1 on the same convs (gate on vs gate off at step 1)
    for label, off, on in (("diffusion", diff_off, diff_on),
                           ("vae", vae_off, vae_on)):
        rows = []
        for b5, b1, layer in sorted(set(b5_vs_b1(cap, label, off, on))):
            r5 = recs[("B5", "diffusion")].get(b5) or recs[(
                "B5", "vae_gate_on")][b5]
            r1 = recs[("B1", f"{label}_gate_off")][b1]
            rows.append({"layer": layer, "volume": r5["volume"],
                         "n_out": b1[0], "cin": b1[1], "cout": b1[2],
                         "b5_ms": r5["ms"], "b1_ms": r1["ms"],
                         "b5_bound_ms": r5["bound_ms"],
                         "b5_dense_ops_ms": r5["dense_ops_ms"],
                         "b1_bound_ms": r1["bound_ms"],
                         "occupied_pairs": r1["matched_pairs"],
                         "dense_pairs": 27 * r5["cells"],
                         "cudnn_ms": r5["library_ms"]})
        emit({"b5_vs_b1": label, "convs": rows})

    # -- path 4: the library path (bench_conv) ----------------------------
    try:
        lib = library_phase(mp, dev, power)
    except Exception:
        traceback.print_exc()
        lib = {"ok": False, "failures": ["library phase raised"], "recs": {},
               "launches": {}}
    need(lib["ok"], "library path: " + ", ".join(lib["failures"]))
    recs.update(lib["recs"])

    # -- end-to-end references on a small input --------------------------
    for ref in (tiny_reference, tiny_train_reference,
                tiny_diffusion_reference):
        try:
            need(ref(mp, dev)["ok"], ref.__name__)
        except Exception:
            traceback.print_exc()
            need(False, ref.__name__)

    emit({"card": power, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(power, flush=True)
    if failed:
        return fail("a phase failed (see the JSON lines above): " +
                    "; ".join(failed))

    def entry(name, launches, t, per):
        _, wrapper, source, replaces = {**KERNELS, **LIBRARY_KERNELS}[name]
        cases = [r for (k, _), got in recs.items() if k == name
                 for r in got.values()]
        cases += [r for r in extras if name == "B1"]
        return {"name": f"{name} {wrapper}", "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": "operations" if t["ops"] > t["bytes"]
                else "bytes", "library_ms": t["library_ms"],
                "per": per + " (sum over its launches)"}

    kernels = []
    for name in FUSED:
        main_path = "generation" if name == "B1" else "vae_train"
        launches = gen_launches[name] if name == "B1" else \
            train_launches[name]
        per = ("one generation request" if name == "B1" else
               "one VAE train step")
        e = entry(name, launches, tot[name], per)
        e.update({"path": main_path,
                  "ms_per_vae_step": tot_vae[name]["ms"],
                  "bound_ms_per_vae_step": tot_vae[name]["bound_ms"],
                  "launches_library_path": lib["launches"].get(name, 0),
                  "launches_vae_train_path": train_launches[name],
                  "launches_diffusion_path": diff["launches"][name],
                  "ms_per_diffusion_step": tot_diff[name]["ms"],
                  "bound_ms_per_diffusion_step": tot_diff[name]["bound_ms"]})
        kernels.append(e)
    for name in BRICK:
        e = entry(name, diff["launches"][name], tot_diff[name],
                  "one diffusion train step")
        e["path"] = "diffusion"
        if name == "B6":
            e["ms_per_vae_gate_on_step"] = tot_gate_on["ms"]
            e["bound_ms_per_vae_gate_on_step"] = tot_gate_on["bound_ms"]
            e["library_ms_per_vae_gate_on_step"] = tot_gate_on["library_ms"]
        kernels.append(e)
    for name in LIBRARY_KERNELS:  # one launch per record on the path
        got = recs[(name, "library")]
        e = entry(name, lib["launches"][name],
                  totals(Counter(dict.fromkeys(got, 1)), got),
                  "one pass of the library path")
        e["path"] = "library"
        if any("bound_fp32_ms" in r for r in got.values()):
            # the same bound with the float32 FMAs at the float32 peak
            e["bound_fp32_ms"] = sum(r.get("bound_fp32_ms", r["bound_ms"])
                                     for r in got.values())
        kernels.append(e)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def profile_run(label: str, run, wall_unprofiled: float) -> None:
    """Device time by kernel name for one call of ``run`` (torch.profiler).
    The profiler slows the host down many times, so the device's busy
    share is taken against the wall time of an unprofiled call.  User
    annotations (``Optimizer.step#…``) span kernels that are counted
    themselves, so they are left out of the sum.  The reading comes from a
    session whose records are whole (``bench_conv.profiled``)."""
    from mink_octtree_stablediffusion_tpu_torch import bench_conv as bc
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in bc.profiled(run)
                   if e.self_device_time_total > 0), reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6

    def kernel_s(pattern):
        return sum(r[0] for r in rows if re.search(pattern, r[1])) / 1e6
    emit({"profile": label, "device_busy_s": busy_s,
          "profiler_records_lost": bc.profiled.lost,
          "profiler_sessions_refused": bc.profiled.refused,
          "device_kernels": sum(r[2] for r in rows),
          # B1 and B2 are one instantiation (B2's weight is cast
          # transposed), told apart only by their launches
          "B1_and_B2_s": kernel_s(r"fused_sparse_conv_kernel<\d+, \d+, 0>"),
          "B3_s": kernel_s("fused_sparse_conv_dw::"),  # all its passes
          "B5_and_dF_s": kernel_s("brick_conv_kernel<"),
          "B6_s": kernel_s("brick_conv_dw::"),  # all its passes
          "wall_s_unprofiled": wall_unprofiled,
          "device_busy_share": busy_s / wall_unprofiled,
          "top_kernels": [{"name": n[:90], "device_ms": d / 1e3, "calls": c}
                          for d, n, c in rows[:20]]})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
