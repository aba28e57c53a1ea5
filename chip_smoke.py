"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py               # from the root of a checkout
    python3 chip_smoke.py --profile     # also profile a request and steps
    python3 chip_smoke.py --max-keep 0  # no generation clamp (MAX_KEEP)

Builds the port's CUDA kernels from `mink_octtree_stablediffusion_tpu_torch/
csrc/` (one ``nvcc`` per source, all at once) and drives the port's
paths, each with the kernels' launch counts set to 0 just before it and
read just after:

- **generation** — `serve.build_generate_fn` of `examples/generate.py`'s
  default configuration with the DDIM scheduler (resolution 128, batch 4,
  65536 input rows, VAE (32, 128, 512, 512, 4), UNet (4, 320, 640, 960) at
  full width, random weights from seed 0), cut to 8 DDIM steps, for 3
  requests (seeds 0, 1, 2).  Each request must give finite features and
  > 0 voxels per instance, and every fused-route conv must launch the
  forward kernel (B1).
- **conditioned canvas generation** — the sampling of
  `scripts/cond_control.py` at the same widths (``canvas_phase``): the
  VAE with the encoder's window attention and the canvas latent, the UNet
  with cross-attention on a seeded [4, 77, 768] condition,
  ``cond_into_time`` and window attention at the stride-8 canvas;
  one encode onto the canvas, then 3 template-free requests (DDIM, 8
  steps, CFG 3.0) from noise on the 16,384-row canvas.  Each request must
  be finite with > 0 voxels per instance, take the window, full and
  cross-attention paths, and launch B1 once per fused-route conv; a
  second condition must move the latent.  It prints the requests' wall
  times, the device's busy share (one profiled request, cut to
  ``CANVAS_PROFILE_STEPS`` DDIM steps) and the peak memory.
- **serving** — ``serve_phase``: the exported generation artifact
  (`serve.py`'s ``export_program``, ``save_artifact``, ``load_artifact``)
  of the generation configuration cut to ``SERVE_STEPS`` DDIM steps,
  exported on the card and loaded from a temporary directory; 2 requests
  through it must equal the direct calls bit for bit (under a control of
  two direct calls) and launch B1 as often.  It prints the export, save
  and load seconds, the program's and weights' bytes and the graph's
  census.  Then the generation entry point (``generate.run``, the path of
  ``python -m ...generate`` without its render) at its full-width
  defaults, DDIM cut to ``STEPS`` steps.
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
  (``gate_compare``, with its planted fault), and again at float32
  compute, where the gate moves the convs from B1-f32 to B5-f32 (dF-f32,
  B6-f32): the loss within 1e-5 and every gradient's relative RMS within
  1e-4 of the gate-off run's, the planted fault outside them, and the
  same off against on on a second (timesteps, noise) draw.
- **canvas and conditioned training** — ``canvas_train_phase``: at the
  canvas path's widths on a batch of 4 `ProceduralShapes` (32,768
  points, ``composite_prob`` 0.25): 10 canvas VAE steps
  (`scripts/e2e_generalize.py` phase 1, its optimizer); the same VAE with
  bf16 parameter storage (``TrainState.create_mixed_precision``), whose
  loss must lie within the bf16 rounding control of the float32 loss;
  10 conditioned canvas diffusion steps (`scripts/cond_control.py`: a
  learned [4, 77, 768] class table, 10% condition dropout, the dropped
  class's table row without a gradient); one canvas diffusion step with
  and without ``remat`` (within the rounding control of each other) and
  two ``--remat --diff_opt adafactor`` steps, then one round of phase 3
  (template-free samples on the canvas, ``STEPS`` DDPM steps, and their
  membership and novelty metrics, ``train.generalize.generation_metrics``);
  two ``train.diffusion``
  steps with ``--remat --noise_point_mode uniform --noise_near`` and the
  brick gate on.  Every step's launches must match its routes, the
  recompute's forward launches included.
- **the library path** — `bench_conv`, the counterpart of `bench.py`'s
  conv metric and its stage scripts, on its three workloads (seed 0): the
  room (26,098 points, 3→32), the finest octree level (131,072 rows,
  32→32) and a 512→512 encoder level, driven once per workload (the
  room's pipeline through B1, B4 and B7; B4 and B7 alone on the others;
  B1's stages, B8 on the room and B9 on the finest level).  Every kernel
  of the path must launch; see ``library_phase`` for what it holds.
- **data parallelism** — ``dp_phase``: two spawned ranks share the card
  in a gloo group (NCCL refuses two ranks on one device), 2 shapes a
  rank: (a) the VAE above with SyncBN, one step with the same batch on
  both ranks against one process's step within a bf16 rounding control,
  then 3 steps on distinct batches; (b) diffusion training as above, 1
  step; (c) one generation request a rank from its own generator, the
  shards gathered through the host, distinct, each equal to this
  process's request with that generator; (d) ``multigpu_dp``'s ResNet14
  at full width, 2 steps.  After every training step the replicas must
  be equal bit for bit, and in each rank the launches must equal its
  routes'; rank 0 sends back the operands of its launch shapes that no
  earlier path launched.  It prints step walls, the all-reduce's host
  seconds and bytes, and each rank's peak memory.  No fallback: a failed
  rank fails the run.
- **tensor parallelism** — ``tp_phase``: four spawned ranks share the
  card in one gloo group as a 2 x 2 ``(data, model)`` mesh
  (``parallel.dp_tp_mesh``): diffusion training at the diffusion path's
  widths with the brick gate on, ``TP_BATCH`` shapes a data row, the
  UNet's conv and dense kernels sharded on Cout over the model axis
  (``parallel.shard_model_params``: B1-B3, B5, dF and B6 at Cout/2), the
  gradients averaged over the data axis: (a) both data rows on the same
  batch and draws, held by rank 0 against one process's step within
  ``TP_CONTROL_FACTOR`` times the larger of two rounding controls; (b)
  ``TP_STEPS`` step(s) on a batch of its own a row.  After each step the
  replicated parameters must be equal bit for bit across the model axis,
  every parameter across the data axis, every slice of its Cout/2 shape,
  and each rank's launches those of its routes; rank 0 sends back the
  operands of its new launch shapes.  It prints the step walls, each
  rank's data-axis and model-axis (activation gathers, dF sums)
  collective bytes and host seconds, its peak memory and the sharded and
  full parameter counts.  No fallback.
- **unbounded grids and the tensor API** — ``unbounded_phase``: the
  library path's room (a ``TensorField`` with no extent) and finest
  level (``make_grid`` with no extent) as unbounded grids, each beside
  its bounded twin: equal voxel sets; the hash-table route equal to the
  sorted search on the card over the k3 kernel map; a k3 conv (the plain
  route) within ``1e-3·max|ref| + 1e-5`` of B1 on the twin, then a
  strided conv, a generative transpose, pruning, a union and the slice
  back to the room's points with the twin's voxel counts; and the
  ``api_demo`` entry point.  It prints the hash build, lookup, kernel-map
  and conv times beside the twin's, and the peak memory.

- **the model zoo** — ``zoo_phase``: the five training entry points of the
  model zoo and ``train.cond``'s oracle (see there).
- **the data path and the utilities** — ``data_phase``: mesh files (OFF,
  OBJ, GLB) written from a seed and read through their datasets;
  ``train.vae --data`` (with its npy cache), ``train.classification
  --data`` and ``train.generalize --stream_device`` (batches synthesized
  on the card) through their entry points; `PrefetchLoader` feeding the
  VAE step; the native voxelizer against its plain paths;
  ``procedural_batch`` against host `ProceduralShapes`; the backend
  self-check and differential suite on the card (see there).
- **precision** — ``precision_phase``: `train.check_bf16_training` at its
  full-width defaults, its steps cut to ``PRECISION_STEPS`` (the VAE
  trained at float32 compute, then at bf16, on 4 fixed batches of sphere
  shells):
  both curves, the verdict (``BF16 TRAINING OK``), each arm's step walls
  and busy share; the float32 arm launches the float32 variants of B1, B2
  and B3 and no plain route, and each variant is held against its float32
  plain version within ``B7_F32_RTOL``·max|ref| at every launch shape;
  B4 at float32 on the library path's three workloads (``library_phase``).
- **float32 brick** — in ``precision_phase``: the float32 arm's first
  ``BRICK_F32_STEPS`` steps again with the brick gate on, from the same
  weights and batches (B5-f32, dF-f32 and B6-f32 at the level-0 32→32
  convs, 64³ × 4 cells), each step's loss within ``BRICK_F32_LOSS_RTOL``
  of the gate-off arm's.
- **quality and diagnosis** — ``quality_phase``: `train.e2e_quality`,
  `train.vqvae_quality` (overfit, then ``--stream``),
  `train.diag_eval_decode` and `train.measure_occupancy` through their
  ``main`` at their scripts' full-width runs, steps cut (see there); their
  JSON keys, finite values, IoUs in [0, 1], the e2e VAE loss falling,
  launches equal to the routes, no plain route; step walls, busy share and
  peak memory.
- **the fused conv's domain** — ``domain_phase``: `tests/test_2d.py`'s
  two cases on the card against the CPU, a 2-D k3 conv on 4 x 256 x 256
  rows (64→64, forward and both gradients: B1, B2, B3 in 2-D against
  their plain versions), and a k=7 cube (K = 343) on the plain route
  against the CPU, with its plain calls counted and no launch.

Then every kernel is held against its plain PyTorch version on the same
bf16-rounded operands, at the shapes its paths gave it (B1 also at a few
extra cases, and on the fully occupied canvas beside one cuDNN call,
``canvas_dense_cases``; the backward kernels with the captured cotangent
scaled by a power of two to unit RMS, see ``unit_rms``), within
``1e-3·max|ref| + 1e-5``, and timed (CUDA events, median of 25 after
warm-up) beside its bound, its plain version and, for the brick kernels
and B1's dense canvas cases, one cuDNN call that computes the same
function.  B1's stages (the cut that B8/B9 time on
the library path) are also timed on the generation path's two heaviest
launch shapes (``stage_table``), and B3's passes, each by its device time,
on the VAE step's two heaviest (``b3_pass_table``, which also holds two
launches bit for bit equal), and B6's passes at every B6 launch shape of
the VAE gate-on step and the diffusion step (``b6_pass_table``: the
same, with the share of live tiles).
B1 is also checked at every launch shape of the artifact's requests.
B1, B2 and B3 are all checked at every launch
shape of the VAE train path, so that its kernel account is complete
(``vae_step_kernel_account``), and of the canvas VAE's steps, on float32
and on bf16 weights (``canvas_vae_step_kernel_account``).  Last, tiny configurations run on the card
and on the CPU (plain versions under the same bf16 compute policy) with
the same weights, inputs and noise: a generation (``tiny_reference``),
conditioned canvas generation (``tiny_canvas_reference``), a VAE train
step (``tiny_train_reference``) and a diffusion train step with the
brick gate on (``tiny_diffusion_reference``, which also runs the card
with the gate off and with the planted fault) must agree within the
tolerances stated there.  Every UNet forward that runs as a CUDA graph
(``models.unet_graph``) must be captured: a capture that fails and leaves
its signature eager fails the script (``count_fallbacks``).

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
import weakref
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
# the serve phase's DDIM steps: its exported graph, and so its export and
# load seconds, grow with them (2 until the quality phase needed the time)
SERVE_STEPS = 1
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
VAE_SCALE = 0.1428
# the canvas path (``canvas_phase``): `scripts/cond_control.py`'s flags at
# full width; the stride-8 canvas (4,096 cells an instance) takes window
# attention, the stride-16 level (512) full attention
CANVAS_FLAGS = dict(attn_max_len=512, attn_window=64, with_cross_attn=True,
                    cross_attention_dim=768, cond_into_time=True,
                    with_window_attn=True, latent_canvas=True)
COND_TOKENS, COND_DIM, GUIDANCE = 77, 768, 3.0  # CLIP text; cond_control's top
# the DDIM steps of the canvas path's profiled request (STEPS until the
# tensor-parallel phase needed the time: torch.profiler's processing of an
# 8-step request's ~288,000 kernels took most of the phase's 221-283 s)
CANVAS_PROFILE_STEPS = 2
# tiny_train_reference's bounds on the relative RMS, card vs CPU, of each
# gradient and of each running-statistic update (see there)
TINY_GRAD_RTOL, TINY_STAT_RTOL = 0.075, 0.02
# tiny_zoo_reference's bound on the share of valid rows where the card's VQ
# argmin picks another code than the CPU's (bf16 near-ties): the H100 read 2
# and 3 of 256; a wrong argmin moves most rows (64 codes)
TINY_CODES_RTOL = 0.03
TRAIN_STEPS, TRAIN_LR, TRAIN_KLD = 10, 1e-3, 1e-6  # train_vae.py's defaults
# diffusion phase: 10 steps; the warmup cut from 1000 to 1 (see the module
# docstring); seed 0 for the weights, as the other paths
DIFF_STEPS, DIFF_FLAGS = 10, ["--seed", "0", "--warmup", "1"]
# the canvas train path (``canvas_train_phase``): `scripts/e2e_generalize.
# py`'s points a shape; 10 steps of the canvas VAE and of conditioned
# diffusion
CANVAS_POINTS, CANVAS_TRAIN_STEPS = 32768, 10
# gate_compare's bounds, gate off vs gate on at step 1 (see there): the
# loss's relative difference, and the relative RMS of the gradients at the
# median tensor and at the worst.  Measured on the H100 (80GB HBM3, 700 W):
# VAE 6.6e-5, 0.019, 0.034; diffusion 1.9e-5, 0.078, 0.33
GATE_TOL = {"vae": {"loss": 1e-3, "grad_median": 0.05, "grad_max": 1.0},
            "diffusion": {"loss": 1e-3, "grad_median": 0.25,
                          "grad_max": 1.0},
            # float32 compute: the brick route's split-term kernels against
            # the fused route's, both float32-accurate.  Measured on the
            # H100 (80GB HBM3, 700 W): loss 1.6e-7, gradients' relative RMS
            # median 4.9e-5 / 5.5e-5 (two draws), worst 6.4e-4 / 2.5e-3, an
            # instance norm's weight or bias whose gradient cancels; the
            # float32 control (the noise moved by 2^-20 of itself) moves
            # the median by 4.8e-5 and the worst by 2.0e-2, so the worst's
            # bound is 1e-2; the planted fault moves them by 1.05 and 75
            "diffusion_f32": {"loss": 1e-5, "grad_median": 1e-4,
                              "grad_max": 1e-2}}
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
    conv's (B, X, Y, Z, Cin, Cout).  A launcher called while a CUDA graph
    of the UNet is captured (inside ``UNetGraphs._capture``, also wrapped)
    launches nothing then: its shape is kept as the graph's (``graphs``)
    and counted at each replay of that graph (``unet_graph._replayed``,
    also wrapped), where no launcher is called; a capture that fails keeps
    nothing."""

    def __init__(self, mp):
        self.fc, self.vc = mp.ops.fused_conv, mp.ops.vol_conv
        self.orig = (self.fc._launch, self.fc._launch_dkernel,
                     self.vc._launch, self.vc._launch_dw)
        self.cases, self.counts, self.b5_order = {}, {}, {}
        self.path, self.on = None, ()
        self.ug = mp.models.unet_graph
        self.orig_graph = (self.ug.UNetGraphs._capture, self.ug._replayed)
        # the shapes of a capture under way, else None; each graph's shapes
        self.pending, self.graphs = None, weakref.WeakKeyDictionary()

    def at(self, path, on=()):
        self.path, self.on = path, tuple(on)

    def case(self, path, name) -> dict:
        return self.cases.get(path, {}).get(name, {})

    def per_step(self, path, name, steps: int) -> Counter:
        total = self.counts.get(path, {}).get(name, Counter())
        assert all(c % steps == 0 for c in total.values()), (path, name)
        return Counter({k: c // steps for k, c in total.items()})

    def keep(self, name, key, ops):
        import torch
        if (self.pending is not None and
                torch.cuda.is_current_stream_capturing()):
            self.pending.append((name, key))
            return
        self.count(name, key)
        if self.path is not None and name in self.on:
            self.cases.setdefault(self.path, {}).setdefault(
                name, {}).setdefault(key, ops)

    def count(self, name, key):
        if self.path is None:
            return
        self.counts.setdefault(self.path, {}).setdefault(
            name, Counter())[key] += 1
        if name == "B5":
            self.b5_order.setdefault(self.path, []).append(key)

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
        capture, replayed = self.orig_graph

        def graph_capture(graphs, *a):
            # the shapes the capture called the launchers with are the
            # graph's launches; its eager warm-up launches and counts
            self.pending = []
            try:
                graph, out = capture(graphs, *a)
            finally:
                shapes, self.pending = self.pending, None
            if graph is not None:
                self.graphs[graph] = shapes
            return graph, out

        def graph_replayed(graph):
            replayed(graph)
            for name, key in self.graphs.get(graph, ()):
                self.count(name, key)

        self.ug.UNetGraphs._capture, self.ug._replayed = (graph_capture,
                                                          graph_replayed)
        return self

    def __exit__(self, *exc):
        (self.fc._launch, self.fc._launch_dkernel, self.vc._launch,
         self.vc._launch_dw) = self.orig
        self.ug.UNetGraphs._capture, self.ug._replayed = self.orig_graph
        self.path = None


def count_fallbacks(mp) -> list:
    """Wrap the UNet graph runner's capture for the rest of the process:
    the returned list gains the feature shape of each capture that failed
    (its signature then runs eager, ``unet.graph_fallback``)."""
    ug, failed = mp.models.unet_graph, []
    capture = ug.UNetGraphs._capture

    def counted(graphs, module, forward, x, *a):
        graph, out = capture(graphs, module, forward, x, *a)
        if graph is None:
            failed.append(tuple(x.features.shape))
        return graph, out
    ug.UNetGraphs._capture = counted
    return failed


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


def compute_args(mp, compute, w_bf16=False) -> dict:
    """``timed_check``'s arguments for a fused kernel at ``compute``
    ("bf16" or "f32"): the compute dtype, its split terms and products
    (``fused_conv.operand_terms``: 1, or 6 on float32 operands and 3 on a
    bf16 weight, each a bf16 product on the tensor cores, which the bound
    counts at the bf16 peak), and the float32 tolerance ``B7_F32_RTOL``
    for float32 compute."""
    import torch
    cd = torch.bfloat16 if compute == "bf16" else torch.float32
    ta, tb = mp.ops.fused_conv.operand_terms(cd, w_bf16)
    out = {"cd": cd, "terms": [ta, tb], "products": sum(
        a + b <= 2 for a in range(ta) for b in range(tb))}
    if compute != "bf16":
        out.update(rel_tol=B7_F32_RTOL, abs_tol=0.0)
    return out


def check_conv_launch(mp, kernel, case, kind, ops, transpose_weight=False,
                      compute="bf16", **extra):
    """B1, or B2 with ``transpose_weight``: ``ops`` = (features, weight,
    keys, out_coords, out_valid, offs, stride, cells) of one launch, B2's
    features being the cotangent, checked at unit RMS; at ``compute``
    "bf16" on bf16-rounded operands, at "f32" (the split-term variant) on
    the float32 operands against the float32 plain version within
    ``B7_F32_RTOL``·max|ref|.  Bytes: the features, the weight, the keys
    and the output coordinates and valid mask read once, the output
    written once; operations: each product term's 2·Cin·Cout a pair."""
    import torch
    fc = mp.ops.fused_conv
    f, w, keys, oc, ov, offs, s, cells = ops
    if transpose_weight:
        f, extra["g_rms"] = unit_rms(f)
        ops = (f,) + tuple(ops[1:])
        extra["min_ref"] = MIN_REF_GRAD
    ca = compute_args(mp, compute, w.dtype == torch.bfloat16)
    cd = ca.pop("cd")
    if compute == "bf16":
        f16, w16 = f.bfloat16().float(), w.bfloat16().float()
    else:
        f16, w16 = f, w.float()
    wp = w16.transpose(1, 2) if transpose_weight else w16
    k, cin, cout = wp.shape
    n_out = oc.shape[0]
    nbytes = (4 * f.numel() + w.element_size() * w.numel() +
              4 * keys.numel() + (5 + 4 * offs.shape[1]) * n_out +
              4 * n_out * cout)
    pairs = matched_pairs(fc, keys, oc, ov, offs, s, cells)
    return timed_check(
        kernel, case, kind,
        lambda: fc._launch(*ops, cd, transpose_weight=transpose_weight),
        lambda: fc._fused_sparse_conv_plain(f16, wp, keys, oc, ov, offs, s,
                                            cells, torch.float32),
        pairs, cin, cout, nbytes,
        flops=2.0 * cin * cout * pairs * ca["products"], n_out=n_out,
        n_in=f.shape[0], k=k, ndim=offs.shape[1], compute=compute,
        **ca, **extra)


def check_case(mp, name, kind, features, kernel, in_grid, out_grid, spec):
    """B1 on one conv's operands."""
    offs, s_in, cells = mp.ops.fused_conv.conv_geometry(in_grid, spec)
    return check_conv_launch(mp, "B1", name, kind, (
        features, kernel, in_grid.flat_keys(), out_grid.coords,
        out_grid.valid, offs, s_in, cells))


def check_dkernel_launch(mp, case, kind, ops, compute="bf16",
                         kernel="B3"):
    """B3: ``ops`` = (features, g, keys, out_coords, out_valid, offs,
    stride, cells) of one launch, checked with ``g`` at unit RMS, at
    ``compute`` as ``check_conv_launch``.  Bytes: the features, the
    cotangent, the keys and the output coordinates and valid mask read
    once, dW (float32 [K, Cin, Cout]) written once."""
    import torch
    fc = mp.ops.fused_conv
    f, g, keys, oc, ov, offs, s, cells = ops
    g, g_rms = unit_rms(g)
    ops = (f, g) + tuple(ops[2:])
    ca = compute_args(mp, compute)
    cd = ca.pop("cd")
    if compute == "bf16":
        f16, g16 = f.bfloat16().float(), g.bfloat16().float()
    else:
        f16, g16 = f, g
    k, (n_in, cin), (n_out, cout) = offs.shape[0], f.shape, g.shape
    nbytes = (4 * f.numel() + 4 * g.numel() + 4 * keys.numel() +
              (5 + 4 * offs.shape[1]) * n_out + 4 * k * cin * cout)
    pairs = matched_pairs(fc, keys, oc, ov, offs, s, cells)
    return timed_check(
        kernel, case, kind,
        lambda: fc._launch_dkernel(*ops, cd),
        lambda: fc._dkernel_plain(f16, g16, keys, oc, ov, offs, s, cells,
                                  torch.float32),
        pairs, cin, cout, nbytes,
        flops=2.0 * cin * cout * pairs * ca["products"],
        min_ref=MIN_REF_GRAD, n_out=n_out, n_in=n_in, k=k,
        ndim=offs.shape[1], g_rms=g_rms, compute=compute, **ca)


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
    (B5 and the dF pass) or ``torch.nn.grad.conv3d_weight`` (B6).

    Float32 volumes (a float32 compute's launch) check the split-term
    instantiation (the record's kernel ``B5-f32``, ``B5-dF-f32``,
    ``B6-f32``) against the float32 plain version within
    ``B7_F32_RTOL``·max|ref|: the bytes count 4 a value, the operations
    each split product (``compute_args``) at the bf16 peak, and cuDNN's
    call is float32 with TF32 off."""
    import torch
    import torch.nn.functional as F
    vc = mp.ops.vol_conv
    b, x, y, z = key[:4]
    cells = b * x * y * z
    extra, min_ref = {}, 0.0
    f32 = ops[0].dtype == torch.float32
    esz = ops[0].element_size()
    ca = compute_args(mp, "f32" if f32 else "bf16",
                      kernel != "B6" and ops[1].dtype == torch.bfloat16)
    ca.pop("cd")
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
        nbytes = esz * cells * (cin + cout) + 4 * 27 * cin * cout
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
        nbytes = esz * cells * cin + w.element_size() * w.numel() + \
            4 * cells * cout
        occ = volp.ne(0).any(-1)
        pairs = occupied_pairs(occ, occ)
        work = occupied_pairs(torch.ones_like(occ), occ)
    products = ca["products"]
    with contextlib.ExitStack() as stack:
        if f32:
            stack.enter_context(tf32_off())
        return timed_check(
            kernel + ("-f32" if f32 else ""), path, "k3s1", run, plain,
            pairs, cin, cout, nbytes, min_ref=min_ref, library=library,
            flops=2.0 * cin * cout * work * products, volume=[b, x, y, z],
            cells=cells, forward_shape=list(key),
            dense_ops_ms=2.0 * 27 * cells * cin * cout * products /
            PEAK_BF16_FLOPS * 1e3, compute="f32" if f32 else "bf16",
            **ca, **extra)


@contextlib.contextmanager
def tf32_off():
    """cuDNN and cuBLAS in float32 without TF32 inside the block."""
    import torch
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


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


def canvas_dense_cases(mp, dev) -> list:
    """B1 on the fully occupied canvas, where every neighbour matches, at
    three k3s1 shapes that the routing sends to the dense branch (cuDNN)
    on the canvas path: the UNet's stride-8 level (4→4), its stride-16
    level (320→320) and the decoder's level 0 (512→512).  Beside B1, one
    cuDNN call on the dense bf16 volume (``F.conv3d``), which on a full
    canvas computes the same function."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(8)
    k3 = mp.ops.KernelSpec(3, 1, ndim=3)
    recs = []
    for stride, cin, cout in ((8, 4, 4), (16, 320, 320), (8, 512, 512)):
        grid = mp.ops.canvas_grid(BATCH, RES, stride, device=dev)
        f = torch.randn(grid.capacity, cin, generator=g, device=dev)
        w = torch.randn(27, cin, cout, generator=g, device=dev) / math.sqrt(
            27 * cin)
        n = RES // stride
        vol = f.bfloat16().reshape(BATCH, n, n, n, cin).permute(
            0, 4, 1, 2, 3).contiguous()
        wl = w.bfloat16().reshape(3, 3, 3, cin, cout).permute(
            4, 3, 0, 1, 2).contiguous()
        offs, s_in, cells = mp.ops.fused_conv.conv_geometry(grid, k3)
        recs.append(check_conv_launch(
            mp, "B1", "canvas_dense", "k3s1", (
                f, w, grid.flat_keys(), grid.coords, grid.valid, offs, s_in,
                cells),
            library=lambda: F.conv3d(vol, wl, padding=1), stride=stride))
    return recs


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
    b, res, cap, steps, scale = 2, 128, 4096, 3, VAE_SCALE
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


def canvas_phase(mp, dev, cap, cpad, valid, max_keep, power) -> dict:
    """Conditioned, template-free generation on the latent canvas: the
    sampling of `scripts/cond_control.py` at `examples/generate.py`'s full
    widths (``serve.generation_models`` with ``CANVAS_FLAGS``: the VAE with
    the encoder's window attention and the canvas latent, the UNet with
    cross-attention at CLIP's [77, 768], ``cond_into_time`` and
    ``attn_window`` 64, ``attn_max_len`` 512; random weights from seed 0).
    With the kernels' counts at 0, it encodes the generation batch once
    and scatters it onto the canvas (``VAE.to_canvas``), then serves 3
    requests (seeds 0-2): DDIM, ``STEPS`` steps with CFG at
    ``GUIDANCE``, from noise on a zero canvas template, under one seeded
    condition, then the pruning decode (clamped at ``max_keep``).  Each
    request must give finite values and > 0 voxels per instance, take the
    window, full and cross-attention paths (``nn.record_attention``) and
    launch B1 once per fused-route conv; the path launches no other
    kernel.  After the counts are read: a second condition on request 0's
    seed must give another latent, and one more request, cut to
    ``CANVAS_PROFILE_STEPS`` DDIM steps, is profiled for the device's busy
    share (against its own unprofiled wall).  ``cap`` keeps B1's operands
    at every launch shape of the path."""
    import torch
    failures = []

    def need(cond, what):
        if not cond:
            failures.append(what)
    vae, unet = mp.serve.generation_models(
        input_capacity=CAP, batch_size=BATCH, vae_channel=VAE_CH,
        unet_channel=UNET_CH, group=GROUP, max_keep=max_keep,
        resolution=RES, device=dev, seed=0, **CANVAS_FLAGS)
    st = mp.sparse_tensor(torch.as_tensor(cpad, device=dev),
                          torch.as_tensor(valid, device=dev)[:, None].float(),
                          capacity=CAP, batch_size=BATCH,
                          valid=torch.as_tensor(valid, device=dev),
                          extent=(RES,) * 3)
    g = torch.Generator(device=dev).manual_seed(11)
    conds = [torch.randn(BATCH, COND_TOKENS, COND_DIM, generator=g,
                         device=dev) for _ in range(2)]
    canvas = mp.ops.canvas_grid(BATCH, RES, 8, device=dev)
    template = mp.SparseTensor(grid=canvas, features=torch.zeros(
        canvas.capacity, UNET_CH[0], device=dev))
    sched = mp.diffusion.DDIMScheduler.create()
    emit({"canvas_models": True, "canvas_rows": canvas.capacity,
          "decoder_capacities": list(vae.decoder_capacities),
          "unet_down_capacities": list(unet.down_capacities),
          "unet_params": sum(p.numel() for p in unet.parameters())})

    @torch.no_grad()
    def generate(cond, seed, steps=STEPS):
        gen = torch.Generator(device=dev).manual_seed(seed)
        z = mp.diffusion.sample_latent(
            unet, sched, template, num_inference_steps=steps,
            encoder_hidden_state=cond, guidance_scale=GUIDANCE,
            generator=gen)
        out_clss, _, sout = vae.decode(
            z.with_features(z.features / VAE_SCALE), st.grid)
        return z, out_clss, sout

    count = counters(mp)
    b1 = count["B1"]
    for c in count.values():
        c.launches = 0  # counts from here on are the canvas path's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cap.at("canvas", ("B1",))
    t0 = time.perf_counter()
    with torch.no_grad(), mp.nn.record_routes() as routes, \
            mp.nn.record_attention() as attn:
        mean, _ = vae.encode(st)
        lat = vae.to_canvas(mean.with_features(mean.features * VAE_SCALE))
    torch.cuda.synchronize()
    enc_routes = routes
    present = lat.features.ne(0).any(-1)
    enc = {"canvas_encode_s": time.perf_counter() - t0,
           "canvas_rows": lat.capacity,
           "present_cells_per_instance": torch.bincount(
               lat.grid.coords[present][:, 0].long(),
               minlength=BATCH).tolist(),
           "attention": dict(Counter(r.kind for r in attn)),
           "fused_route_convs": sum(r.branch == "fused" for r in routes),
           "kernel_launches": b1.launches}
    emit(enc)
    need(bool(torch.isfinite(lat.features).all()) and
         lat.capacity == canvas.capacity and
         min(enc["present_cells_per_instance"]) > 0, "canvas encode")
    need(enc["attention"] == {"window": 1}, "the encoder's window attention")
    need(enc["kernel_launches"] == enc["fused_route_convs"],
         "canvas encode: B1 launches")
    fused_total, requests, per_request_routes = \
        enc["fused_route_convs"], [], []
    z0 = None
    for seed in (0, 1, 2):
        cap.at("canvas", ("B1",))
        before = b1.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mp.nn.record_routes() as routes, \
                mp.nn.record_attention() as attn:
            z, out_clss, sout = generate(conds[0], seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        v = sout.grid.valid
        per_inst = torch.bincount(sout.grid.coords[v][:, 0].long(),
                                  minlength=BATCH).tolist()
        fused = sum(r.branch == "fused" for r in routes)
        kinds = Counter(r.kind for r in attn)
        finite = bool(torch.isfinite(z.features).all() and
                      torch.isfinite(sout.features).all())
        rec = {"canvas_request": seed, "wall_s": wall,
               "voxels_per_instance": per_inst,
               "decoder_levels": decoder_levels(out_clss, BATCH),
               "attention": dict(kinds),
               "attention_rows": sorted(Counter(
                   (r.kind, r.rows, r.channels, r.keys)
                   for r in attn).items()),
               "fused_route_convs": fused,
               "kernel_launches": b1.launches - before,
               "convs": len(routes),
               "branches": dict(Counter(r.branch for r in routes)),
               "finite": finite}
        emit(rec)
        requests.append(rec)
        per_request_routes.append(routes)
        fused_total += fused
        need(finite, f"canvas request {seed}: finite values")
        need(min(per_inst) > 0, f"canvas request {seed}: an empty instance")
        need(all(kinds[k] > 0 for k in ("window", "full", "cross")),
             f"canvas request {seed}: window, full and cross-attention")
        need(rec["kernel_launches"] == fused,
             f"canvas request {seed}: B1 launches")
        if seed == 0:
            z0 = z.features.clone()
    cap.at(None)
    launches = {n: c.launches for n, c in count.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    need(launches["B1"] == fused_total > 0 and
         not any(launches[n] for n in KERNELS if n != "B1"),
         "canvas path launches")
    # not counted: a second condition, and a profiled request
    zb, _, _ = generate(conds[1], 0)
    dz = float((zb.features - z0).abs().max() / z0.abs().max())
    need(dz > 1e-3, "two conditions give the same latent")
    wall_request = statistics.median(r["wall_s"] for r in requests[1:])

    def short_request():
        return generate(conds[0], 9, CANVAS_PROFILE_STEPS)
    short_request()  # warm, then its unprofiled wall
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short_request()
    torch.cuda.synchronize()
    prof = profile_run(
        f"one canvas request cut to {CANVAS_PROFILE_STEPS} DDIM steps",
        short_request, time.perf_counter() - t0)
    rec = {"canvas_path_launches": launches, "card": power,
           "fused_route_convs": fused_total,
           "wall_s_requests_2_3": [r["wall_s"] for r in requests[1:]],
           "wall_s_median": wall_request,
           "device_busy_share": prof["device_busy_share"],
           "peak_memory_bytes": peak,
           "condition_rel_change": dz,
           "failures": failures}
    emit(rec)
    return {"ok": not failures, "failures": failures,
            "routes": per_request_routes[0],
            "all_routes": enc_routes + per_request_routes[0],
            "launches": launches, "record": rec, "requests": requests}


def serve_phase(mp, dev, cap, cpad, valid, max_keep, power) -> dict:
    """The serving artifact (`serve.py`: ``export_program``,
    ``save_artifact``, ``load_artifact``) of path 1's configuration at full
    width, cut to ``SERVE_STEPS`` DDIM steps (the exported graph grows with
    the steps): random weights from seed 0, the decoder clamped at
    ``max_keep``.  With the kernels' counts at 0:

    - the control: two direct calls of ``build_generate_fn``'s function
      with seed 0 must agree bit for bit (else both differences are
      printed and the phase fails), and each must launch B1 once per
      fused-route conv; one more direct call with seed 1;
    - the program is exported on the card, written to a temporary
      directory with the two state dicts, and loaded (``load_artifact``);
    - 2 requests through the artifact (seeds 0 and 1) must give the direct
      calls' (coords, valid) bit for bit, and launch B1 as often as a
      direct call.  ``cap`` keeps B1's operands at every launch shape of
      the artifact's run (path ``serve``).

    Prints the export, save and load seconds, the program's and the
    weights' bytes, the graph's nodes and their census by operator, and
    the request walls (artifact and direct)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    failures = []

    def need(cond, what):
        if not cond:
            failures.append(what)
    vae, unet = mp.serve.generation_models(
        input_capacity=CAP, batch_size=BATCH, vae_channel=VAE_CH,
        unet_channel=UNET_CH, group=GROUP, max_keep=max_keep, device=dev,
        seed=0)
    fn = mp.serve.build_generate_fn(
        vae, unet, mp.diffusion.DDIMScheduler.create(), input_capacity=CAP,
        batch_size=BATCH, resolution=RES, vae_scale=VAE_SCALE,
        sample_steps=SERVE_STEPS, device=dev)
    count = counters(mp)
    b1 = count["B1"]
    for c in count.values():
        c.launches = 0  # counts from here on are the serve path's

    def request(run):
        before = b1.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mp.nn.record_routes() as routes:
            out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, b1.launches - before, routes

    def direct(seed):
        return fn(cpad, valid, generator=torch.Generator(
            device=dev).manual_seed(seed))
    refs, direct_walls = {}, []
    for seed in (0, 0, 1):
        out, wall, launched, routes = request(lambda: direct(seed))
        fused = sum(r.branch == "fused" for r in routes)
        need(launched == fused > 0, f"direct call (seed {seed}): B1 "
             "launches")
        direct_walls.append(wall)
        if seed in refs:  # the control: the same seed twice
            same = [torch.equal(a, b) for a, b in zip(out, refs[seed])]
            if not all(same):
                emit({"serve_control_differs": {
                    "coords_rows": int((out[0] != refs[seed][0]).any(
                        1).sum()),
                    "valid_rows": int((out[1] != refs[seed][1]).sum())}})
            need(all(same), "two direct calls with one seed agree")
        refs[seed] = out
        direct_launches = launched
    vs, us = vae.state_dict(), unet.state_dict()
    t0 = time.perf_counter()
    ep = mp.serve.export_program(fn, vs, us, cpad, valid)
    export_s = time.perf_counter() - t0
    census = Counter(str(n.target) for n in ep.graph.nodes
                     if n.op == "call_function")
    nodes = len(ep.graph.nodes)
    d = tempfile.mkdtemp(prefix="serve_artifact_")
    try:
        t0 = time.perf_counter()
        data = mp.serve.serialize(ep)
        mp.serve.save_artifact(d, fn, vs, us, (cpad, valid), program=data)
        save_s = time.perf_counter() - t0
        del ep
        t0 = time.perf_counter()
        generate = mp.serve.load_artifact(d)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    artifact_walls, artifact_launches = [], []
    for seed in (0, 1):
        cap.at("serve", ("B1",))
        (coords, mask), wall, launched, _ = request(
            lambda: generate(cpad, valid, seed=seed))
        cap.at(None)
        ref = [t.cpu().numpy() for t in refs[seed]]
        equal = (np.array_equal(coords, ref[0]) and
                 np.array_equal(mask, ref[1]))
        per_inst = np.bincount(coords[mask][:, 0], minlength=BATCH).tolist()
        emit({"serve_request": seed, "wall_s": wall,
              "kernel_launches": launched, "voxels_per_instance": per_inst,
              "equals_direct_call": equal})
        need(equal, f"artifact request {seed}: (coords, valid) equal the "
             "direct call's")
        need(launched == direct_launches, f"artifact request {seed}: B1 "
             "launches per request equal the direct call's")
        need(min(per_inst) > 0, f"artifact request {seed}: an empty "
             "instance")
        artifact_walls.append(wall)
        artifact_launches.append(launched)
    launches = {n: c.launches for n, c in count.items()}
    need(not any(launches[n] for n in KERNELS if n != "B1"),
         "serve path launches only B1")
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in list(vs.values()) + list(us.values()))
    rec = {"serve_path_launches": launches, "card": power,
           "sample_steps": SERVE_STEPS, "export_s": export_s,
           "save_s": save_s, "load_s": load_s, "program_bytes": len(data),
           "weight_bytes": weight_bytes, "graph_nodes": nodes,
           "graph_census": dict(census.most_common()),
           "b1_launches_per_request": {"direct": direct_launches,
                                       "artifact": artifact_launches},
           "wall_s_direct": direct_walls, "wall_s_artifact": artifact_walls,
           "failures": failures}
    emit(rec)
    return {"ok": not failures, "failures": failures, "launches": launches,
            "record": rec}


def generate_cli_phase(mp, dev) -> dict:
    """The generation entry point (``python -m ...generate``) without its
    render: ``generate.run`` at its full-width defaults (random weights
    from seed 0, no decoder clamp), with DDIM cut to ``STEPS`` steps: an
    encode and two sampling runs.  Every value finite, > 0 voxels, and B1
    launched once per fused-route conv."""
    import torch
    from mink_octtree_stablediffusion_tpu_torch import generate as gen_cli
    cfg = gen_cli.parse_args(["--scheduler", "ddim", "--sample_steps",
                              str(STEPS)])
    b1 = counters(mp)["B1"]
    before = b1.launches
    with mp.nn.record_routes() as routes:
        out = gen_cli.run(cfg)
    torch.cuda.synchronize()
    sout = out["sout"]
    rec = {"generate_cli": True, "first_s": out["first_s"],
           "steady_s": out["steady_s"], "voxels": int(sout.valid.sum()),
           "finite": bool(torch.isfinite(sout.features).all()),
           "kernel_launches": b1.launches - before,
           "fused_route_convs": sum(r.branch == "fused" for r in routes)}
    rec["ok"] = (rec["finite"] and rec["voxels"] > 0 and
                 rec["kernel_launches"] == rec["fused_route_convs"] > 0)
    emit(rec)
    return rec


def tiny_canvas_reference(mp, dev) -> dict:
    """The canvas path at a tiny size (VAE (8, 16, 32, 32, 4), UNet (4, 8,
    16, 16), resolution 32, batch 2; ``attn_max_len`` 32 and window 16, so
    that the stride-8 canvas takes the window path and stride 16 full
    attention) on the card and on the CPU, with the same weights,
    condition and noise, both under the card's bf16 compute policy, held
    as ``tiny_reference`` holds its stages:

    - the canvas latent (encode, then ``to_canvas``): max|Δ| ≤
      1e-2·max|ref|;
    - one conditioned UNet forward on N(0,1) canvas features: ‖Δ‖ ≤
      0.25·‖ref‖;
    - the decoded voxel set of one sampled latent (the CPU's, DDIM with
      CFG): IoU ≥ 0.95.

    The voxel sets of a whole template-free generation on each side are
    compared too, and reported."""
    import torch
    b, res, cap, steps = 2, 32, 2048, 3
    kw = dict(input_capacity=cap, batch_size=b,
              vae_channel=(8, 16, 32, 32, 4), unet_channel=(4, 8, 16, 16),
              group=4, resolution=res,
              **dict(CANVAS_FLAGS, attn_max_len=32, attn_window=16))
    vae_c, unet_c = mp.serve.generation_models(device="cpu", seed=3, **kw)
    vae_g, unet_g = mp.serve.generation_models(device=dev, seed=3, **kw)
    vae_g.load_state_dict(vae_c.state_dict())
    unet_g.load_state_dict(unet_c.state_dict())
    ds = mp.data.SyntheticShapes(resolution=res, num_samples=b,
                                 points_per_shape=600)
    cpad, valid, _, _ = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(b)], cap)
    g = torch.Generator().manual_seed(5)
    cond = torch.randn(b, COND_TOKENS, COND_DIM, generator=g)
    shape = (b * (res // 8) ** 3, 4)
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
        with mp.nn.record_attention() as attn:
            mean, _ = vae.encode(st)
            lat = vae.to_canvas(mean)
            t = torch.tensor([600, 40], dtype=torch.int32, device=d)
            u = unet(lat.with_features(x_unet.to(d)), t, cond.to(d))
        template = lat.with_features(torch.zeros_like(lat.features))

        def sample(init):
            return mp.diffusion.sample_latent(
                unet, sched, template, num_inference_steps=steps,
                encoder_hidden_state=cond.to(d), guidance_scale=GUIDANCE,
                init_noise=init).features
        if not z:
            z.append(sample(noise))
        _, _, sout = vae.decode(lat.with_features(z[0].to(d) / VAE_SCALE),
                                st.grid)
        _, _, gout = vae.decode(
            lat.with_features(sample(noise.to(d)) / VAE_SCALE), st.grid)
        return (lat.features.cpu(), u.features.cpu(),
                voxel_set(sout.grid.coords, sout.grid.valid),
                voxel_set(gout.grid.coords, gout.grid.valid),
                Counter(r.kind for r in attn))

    mp.ops.set_default_compute_dtype(torch.bfloat16)
    try:
        got = {"cpu": side(vae_c, unet_c, torch.device("cpu")),
               "gpu": side(vae_g, unet_g, dev)}
    finally:
        mp.ops.set_default_compute_dtype(None)
    c, gp = got["cpu"], got["gpu"]
    rel = float((gp[0] - c[0]).abs().max() / c[0].abs().max())
    unet_rms = float((gp[1] - c[1]).norm() / c[1].norm())
    iou = [len(c[i] & gp[i]) / max(len(c[i] | gp[i]), 1) for i in (2, 3)]
    kinds = gp[4]
    rec = {"tiny_canvas_reference": True, "vs": "cpu, same bf16 policy",
           "canvas_latent_rel_err": rel, "unet_rms_rel_err": unet_rms,
           "attention": dict(kinds),
           "decode_voxels_cpu": len(c[2]), "decode_voxels_gpu": len(gp[2]),
           "decode_voxel_iou": iou[0], "generate_voxel_iou": iou[1],
           "ok": bool(rel <= 1e-2 and unet_rms <= 0.25 and iou[0] >= 0.95
                      and len(c[2]) > 0 and kinds == c[4] and
                      all(kinds[k] > 0 for k in ("window", "full",
                                                 "cross")))}
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
    fused-route (brick-route) conv, a rematerialized stack's recompute in
    the backward pass included; B3 (B6) where its kernel is trained, B2
    (the dF pass) where its input carries a gradient, once per conv (a
    recompute launches no backward kernel); a fused conv of more than
    ``fused_conv.MAX_K`` offsets launches each once per band of offsets."""
    from mink_octtree_stablediffusion_tpu_torch.ops.fused_conv import \
        offset_bands
    out = {}
    for names, branch in ((FUSED, "fused"), (BRICK, "brick")):
        rs = [(r, len(offset_bands(r.k)) if branch == "fused" else 1)
              for r in routes if r.branch == branch]
        first = [(r, n) for r, n in rs if not r.recompute]
        out.update(zip(names, (sum(n for _, n in rs),
                               sum(n * r.grad_in for r, n in first),
                               sum(n * r.grad_w for r, n in first))))
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


@contextlib.contextmanager
def compute_dtype(mp, dtype):
    """The convs' compute dtype inside the block (``None``: the device's
    default)."""
    mp.ops.set_default_compute_dtype(dtype)
    try:
        yield
    finally:
        mp.ops.set_default_compute_dtype(None)


GATE_ARMS = ("off", "control", "on", "fault")


def gate_compare(mp, label, model, run_loss, cap, restore=None,
                 compute=None, arms=GATE_ARMS, tol=None):
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
    to see a layout fault in the brick route's backward.

    With ``compute`` (float32) every arm runs at that compute dtype: the
    gate then moves the convs from B1-f32 to B5-f32 (and the backward to
    dF-f32 and B6-f32), float32-accurate on both routes, under the tighter
    bounds of ``GATE_TOL["diffusion_f32"]``.  ``arms`` runs a subset (the
    comparison's ``off`` and ``on`` alone on a further draw); ``tol``
    overrides ``GATE_TOL[label]``."""
    import torch
    got = {}
    for name, gate, perturb in (("off", False, False),
                                ("control", False, True),
                                ("on", True, False),
                                ("fault", True, False)):
        if name not in arms:
            continue
        mp.ops.enable_brick_conv(gate)
        if name in ("off", "on"):
            cap.at(f"{label}_gate_{name}", BRICK if gate else ("B1",))
        model.zero_grad(set_to_none=True)
        try:
            with contextlib.ExitStack() as stack:
                if compute is not None:
                    stack.enter_context(compute_dtype(mp, compute))
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
    tol = tol or GATE_TOL[label]

    def against_off(loss, grads):
        return against(loss, grads, l0, g0)

    def holds(d):
        return (d["loss_rel_err"] <= tol["loss"] and
                d["grad_rel_rms_median"] <= tol["grad_median"] and
                d["grad_rel_rms_max"] <= tol["grad_max"])
    on = against_off(l1, g1)
    extra = {name + "_" + k: v for name in ("control", "fault")
             if name in got for k, v in against_off(*got[name][:2]).items()}
    fault = against_off(*got["fault"][:2]) if "fault" in got else None
    brick = [r for r in r1 if r.branch == "brick"]
    rec = {"gate_compare": label, "loss_gate_off": l0, "loss_gate_on": l1,
           "compute": str(compute or "default"), **on, **extra,
           "fault_detected": None if fault is None else not holds(fault),
           "params_with_grad": len(g0),
           "branches_gate_off": dict(Counter(r.branch for r in r0)),
           "branches_gate_on": dict(Counter(r.branch for r in r1)),
           "tol": tol,
           "ok": bool(brick and len(g0) == sum(
               1 for _ in model.parameters() if _.requires_grad) and
               holds(on) and (fault is None or not holds(fault)))}
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
    gate off and on (``gate_compare``), and the same at float32 compute,
    also on a second draw (``compare_f32``: B5-f32, dF-f32 and B6-f32
    against the fused route's float32 kernels).  ``cap`` keeps step 1's
    operands of every kernel.  Returns the step records, step 1's routes,
    the path's launches, the gate comparisons, the peak memory and the
    run."""
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
    t2 = torch.randint(0, cfg.ddpm_num_steps, (cfg.batch_size,), generator=g,
                       device=dev, dtype=torch.int32)
    noise2 = torch.randn(noise.shape, generator=g, device=dev)
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
    # at float32 compute (B1-f32 against B5-f32, dF-f32, B6-f32): step 1's
    # draw with the planted fault and a float32 control (the noise moved by
    # 2^-20 of itself, about the split-term kernels' own error), then gate
    # off against on alone on a second (timesteps, noise) draw
    compare_f32 = [gate_compare(
        mp, "diffusion_f32", model, lambda perturb: run.loss_fn(
            model, batch, timesteps=t,
            noise=noise * (1.0 + 2.0 ** -20) if perturb else noise), cap,
        compute=torch.float32)[0], gate_compare(
        mp, "diffusion_f32_step2", model, lambda perturb: run.loss_fn(
            model, batch, timesteps=t2, noise=noise2), cap,
        compute=torch.float32, arms=("off", "on"),
        tol=GATE_TOL["diffusion_f32"])[0]]
    torch.cuda.empty_cache()
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
            "compare": compare, "compare_f32": compare_f32,
            "peak_memory_bytes": peak, "one_more_step": one_more_step}


def grads_of(model) -> dict:
    return {n: p.grad.detach().float().clone()
            for n, p in model.named_parameters() if p.grad is not None}


def against(loss, grads, loss0, grads0) -> dict:
    """A run's loss and gradients against a reference run's: the loss's
    relative difference, the gradients' relative RMS at the median tensor
    and at the worst."""
    rel = (rel_rms(grads, grads0) if set(grads) == set(grads0)
           else {"(names differ)": 1e9})
    worst = max(rel, key=rel.get)
    return {"loss_rel_err": abs(loss - loss0) / max(abs(loss0), 1e-30),
            "grad_rel_rms_median": statistics.median(rel.values()),
            "grad_rel_rms_max": rel[worst], "grad_worst": worst}


def canvas_train_phase(mp, dev, cap, power) -> dict:
    """Training of the canvas and conditioned models (`scripts/
    e2e_generalize.py` phases 1 and 2, `scripts/cond_control.py`'s
    diffusion) at the canvas path's full widths: resolution 128, batch 4
    of `ProceduralShapes` (samples 0-3 of the train split, seed 0,
    32,768 points, ``composite_prob`` 0.25; one of each class), the VAE
    (32, 128, 512, 512, 4) with ``latent_canvas`` (decoder level 0:
    16,384 canvas rows), random weights from seed 0.  With the kernels'
    counts at 0:

    a. 10 canvas VAE steps (``train.generalize``'s loss and optimizer:
       clipping at 1.0, Adam on the 20-step warmup of a 6000-step cosine)
       on the batch.  Every loss and gradient finite, every parameter with
       a gradient, B1/B2/B3 launched as the routes call for, the loss of
       step 10 below step 1's and the BCE too.  ``cap`` keeps step 1's
       B1/B2/B3 operands (path ``canvas_vae``).
    b. The same VAE (fresh, seed 0) with bf16 parameter storage
       (``TrainState.create_mixed_precision``): 3 steps from fixed draws.
       Step 1's loss must lie within the bf16 rounding control of the
       float32 loss: |L_bf16 − L_fp32| ≤ 2·|L_round − L_fp32| +
       1e-5·|L_fp32|, L_round being the float32 model with its weights
       rounded to bf16; the live parameters stay bf16 and equal
       round(master).  ``cap`` keeps step 1's operands (path
       ``canvas_vae_bf16``: every launch reads a bf16 weight).
    c. 10 steps of conditioned canvas diffusion (``train.cond``'s loss on
       the frozen VAE of (a): the UNet (4, 320, 640, 960), group 32, with
       cross-attention on a learned [4, 77, 768] class table,
       ``cond_into_time``, ``attn_max_len`` 512, ``attn_window`` 64, the
       ``sample`` target, ``cond_dropout`` 0.1, AdamW at 2e-4 on a
       100-step warmup).  Step 1 drops instance 0 (class 0) by a given
       mask: the table's row 0 must get a zero gradient, the others not;
       every parameter gets a gradient at every step.
    d. One canvas diffusion step of phase 2 (the same UNet without the
       condition) with and without ``remat``, from the same weights and
       draws, and a control without remat on noise rounded to bf16: the
       remat step's loss and gradients must lie within the control's
       distance of the plain step's; then two ``--remat --diff_opt
       adafactor`` steps must stay finite and move the weights.  Peak
       memory with and without remat.
    e. Two ``train.diffusion`` steps at the diffusion phase's
       configuration with ``--remat --noise_point_mode uniform
       --noise_near`` and the brick gate on: B1/B2/B3 and B5/dF/B6
       launched as the routes call for, the recompute's forward launches
       included (``expected_launches``).  ``cap`` keeps step 1's operands
       of every kernel (path ``noise_points``).

    Reports each part's step walls, peak memory and launches, the
    device's busy share and elementwise time of one float32 and one bf16
    canvas VAE step, and the busy share of one conditioned step
    (``profile_run``)."""
    import torch
    from mink_octtree_stablediffusion_tpu_torch.train import (
        cond as tcond, diffusion as td, generalize as tg, vae as tv)
    failures = []

    def need(ok, what):
        if not ok:
            failures.append(what)
    ds = mp.data.ProceduralShapes(resolution=RES, num_samples=BATCH,
                                  points_per_shape=CANVAS_POINTS, seed=0,
                                  composite_prob=0.25)
    batch = tg.collate([ds[i] for i in range(BATCH)], CAP)
    sizes = dict(input_capacity=CAP, batch_size=BATCH, resolution=RES)
    count = counters(mp)
    for c in count.values():
        c.launches = 0  # counts from here on are the canvas train path's
    out = {"records": {}}

    def run_steps(label, step_fn, n, model, on=FUSED, each=None):
        recs = []
        for i in range(n):
            cap.at(label, on if i == 0 else ())
            kw = each(i) if each else {}
            before = {k: c.launches for k, c in count.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mp.nn.record_routes() as routes:
                loss, aux = step_fn(**kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cap.at(None)
            launched = {k: c.launches - before[k] for k, c in count.items()}
            missing = [k for k, p in model.named_parameters()
                       if p.requires_grad and p.grad is None]
            finite = bool(torch.stack(
                [torch.isfinite(loss)] +
                [torch.isfinite(p.grad).all() for p in model.parameters()
                 if p.grad is not None]).all().item())
            rec = {label + "_step": i + 1, "wall_s": wall,
                   "loss": float(loss),
                   **{k: float(v) for k, v in aux.items()},
                   "launches": launched,
                   "expected_launches": expected_launches(routes),
                   "convs": len(routes),
                   "recomputed_convs": sum(r.recompute for r in routes),
                   "branches": dict(Counter(r.branch for r in routes)),
                   "params_without_grad": missing[:5],
                   "all_finite": finite}
            emit(rec)
            recs.append(rec)
            need(finite and not missing, f"{label} step {i + 1}: finite "
                 "loss and a gradient for every parameter")
            need(launched == rec["expected_launches"],
                 f"{label} step {i + 1}: launches")
            if i == 0:
                out.setdefault("routes", {})[label] = routes
        return recs

    # (a) the canvas VAE, 10 steps
    t0 = time.perf_counter()
    vae = tg.canvas_vae(vae_channel=VAE_CH, device=dev, seed=0, **sizes)
    loss_fn = tv.build_loss_fn(kld_weight=TRAIN_KLD, device=dev, **sizes)
    state = mp.train.TrainState(vae, mp.train.canvas_vae_optimizer(
        vae.parameters(), TRAIN_LR, 6000))
    step = mp.train.make_train_step(loss_fn)
    gen = torch.Generator(device=dev).manual_seed(0)
    emit({"canvas_train_models_built_s": time.perf_counter() - t0,
          "input_voxels_per_instance": [int((batch[0][:, 0] == i).sum())
                                        for i in range(BATCH)],
          "labels": batch[3].tolist(),
          "decoder_capacities": list(vae.decoder_capacities)})
    torch.cuda.reset_peak_memory_stats(dev)
    vae_recs = run_steps("canvas_vae", lambda: step(state, batch[:3], gen),
                         CANVAS_TRAIN_STEPS, vae)
    peak_vae = torch.cuda.max_memory_allocated(dev)
    loss = [r["loss"] for r in vae_recs]
    need(loss[-1] < loss[0] and vae_recs[-1]["bce"] < vae_recs[0]["bce"],
         "canvas VAE: the loss and the BCE fall")
    wall_vae = statistics.median(r["wall_s"] for r in vae_recs[1:])
    prof32 = profile_run("one canvas VAE step (float32 weights)",
                         lambda: step(state, batch[:3], gen), wall_vae)
    launches_a = {k: c.launches for k, c in count.items()}

    # (b) bf16 parameter storage, from fixed draws
    enc_caps = mp.serve.capacities(CAP)[0]
    g1 = torch.Generator(device=dev).manual_seed(1)
    eps = torch.randn((enc_caps[2], VAE_CH[4]), generator=g1, device=dev)
    cnoise = torch.randn((BATCH * (RES // 8) ** 3, VAE_CH[4]), generator=g1,
                         device=dev)
    draws = dict(eps=eps, canvas_noise=cnoise)

    def fresh_vae():
        return tg.canvas_vae(vae_channel=VAE_CH, device=dev, seed=0,
                             **sizes).train()

    def loss_at(model):
        stats = [b.clone() for b in model.buffers()]
        with torch.no_grad():
            val = float(loss_fn(model, batch[:3], **draws)[0])
            for b, s in zip(model.buffers(), stats):
                b.copy_(s)
        return val
    l32 = loss_at(fresh_vae())
    rounded = fresh_vae()
    with torch.no_grad():
        for p in rounded.parameters():
            p.copy_(p.bfloat16().float())
    l_round = loss_at(rounded)
    del rounded
    vae16 = fresh_vae()
    state16 = mp.train.TrainState.create_mixed_precision(
        vae16, lambda ps: mp.train.canvas_vae_optimizer(ps, TRAIN_LR, 6000))
    step16 = mp.train.make_train_step(loss_fn)
    torch.cuda.reset_peak_memory_stats(dev)
    bf16_recs = run_steps(
        "canvas_vae_bf16", lambda: step16(state16, batch[:3], **draws), 3,
        vae16)
    peak_bf16 = torch.cuda.max_memory_allocated(dev)
    l16 = bf16_recs[0]["loss"]
    live_ok = all(p.dtype == torch.bfloat16 and torch.equal(
        p, m.to(torch.bfloat16)) for p, m in zip(state16.optimizer.params,
                                                 state16.optimizer.master))
    bound = 2 * abs(l_round - l32) + 1e-5 * abs(l32)
    rec_b = {"canvas_vae_bf16_loss_step1": l16, "loss_fp32": l32,
             "loss_fp32_rounded_weights": l_round,
             "bf16_minus_fp32": abs(l16 - l32),
             "control_rounded_minus_fp32": abs(l_round - l32),
             "bound": bound, "live_equals_round_master": live_ok}
    emit(rec_b)
    need(abs(l16 - l32) <= bound, "canvas VAE bf16: the loss within the "
         "bf16 rounding control")
    need(live_ok, "canvas VAE bf16: live parameters are round(master)")
    wall_bf16 = statistics.median(r["wall_s"] for r in bf16_recs[1:])
    prof16 = profile_run("one canvas VAE step (bf16 weights)",
                         lambda: step16(state16, batch[:3], **draws),
                         wall_bf16)
    del vae16, state16, step16
    torch.cuda.empty_cache()
    launches_b = {k: c.launches for k, c in count.items()}

    # (c) conditioned canvas diffusion on the frozen VAE of (a)
    del state, step
    vae.requires_grad_(False)
    vae.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    table = torch.as_tensor(tcond.class_table(4, COND_TOKENS, COND_DIM),
                            device=dev)
    unet_kw = dict(unet_channel=UNET_CH, batch_size=BATCH, resolution=RES,
                   group=GROUP, attn_max_len=512, attn_window=64,
                   device=dev, seed=1)
    unet = tg.canvas_unet(with_cross_attn=True, cross_attention_dim=COND_DIM,
                          cond_into_time=True, **unet_kw)
    model = torch.nn.ModuleDict({"unet": unet})
    model.register_parameter("cond_table", torch.nn.Parameter(table.clone()))
    cstate = mp.train.TrainState(model, mp.train.diffusion_optimizer(
        model.parameters(), 2e-4, 100, 10000))
    sample = mp.diffusion.DDPMScheduler.create(prediction_type="sample")
    cstep = mp.train.make_train_step(tg.build_diffusion_loss_fn(
        vae, sample, vae_scale=VAE_SCALE, prediction_type="sample",
        device=dev, cond_table=table, cond_dropout=0.1, **sizes))
    gen_c = torch.Generator(device=dev).manual_seed(2)
    drop1 = torch.arange(BATCH, device=dev) == 0  # instance 0 only
    table_rows = {}

    def cond_step(drop=None):
        loss, aux = cstep(cstate, batch, gen_c, drop=drop)
        if drop is not None:
            g = model.cond_table.grad
            table_rows["grad_max_per_row"] = g.abs().amax((1, 2)).tolist()
        return loss, aux
    torch.cuda.reset_peak_memory_stats(dev)
    cond_recs = run_steps("cond_canvas_diffusion", cond_step,
                          CANVAS_TRAIN_STEPS, model, on=(),
                          each=lambda i: {"drop": drop1} if i == 0 else {})
    peak_cond = torch.cuda.max_memory_allocated(dev)
    wall_cond = statistics.median(r["wall_s"] for r in cond_recs[1:])
    prof_cond = profile_run("one conditioned canvas diffusion step",
                            cond_step, wall_cond)
    rows = table_rows["grad_max_per_row"]
    # every instance has its canvas, an empty one too: each undropped
    # instance's class gets a gradient
    kept = {int(c) for c, d in zip(batch[3], drop1.tolist()) if not d}
    need(all((r > 0) == (c in kept) for c, r in enumerate(rows)),
         "cond diffusion: only the undropped classes' table rows get a "
         "gradient")
    emit({"cond_table_grad_max_per_row_step1": rows,
          "labels": batch[3].tolist(), "dropped": [0]})
    del cstate, cstep, model, unet
    torch.cuda.empty_cache()
    launches_c = {k: c.launches for k, c in count.items()}

    # (d) phase 2's step with and without remat; then remat + Adafactor
    unet = tg.canvas_unet(**unet_kw)
    dmodel = torch.nn.ModuleDict({"unet": unet})
    dloss = tg.build_diffusion_loss_fn(
        vae, sample, vae_scale=VAE_SCALE, prediction_type="sample",
        device=dev, **sizes)
    g3 = torch.Generator(device=dev).manual_seed(3)
    t = torch.randint(0, 1000, (BATCH,), generator=g3, device=dev,
                      dtype=torch.int32)
    dnoise = torch.randn((BATCH * (RES // 8) ** 3, UNET_CH[0]),
                         generator=g3, device=dev)
    runs, gr0, l0 = {}, None, None
    dmodel.train()
    for name, remat, perturb in (("plain", False, False),
                                 ("control", False, True),
                                 ("remat", True, False)):
        unet.remat = remat
        dmodel.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with mp.nn.record_routes() as routes:
            loss, _ = dloss(dmodel, batch, timesteps=t,
                            noise=dnoise.bfloat16().float() if perturb
                            else dnoise)
            loss.backward()
        torch.cuda.synchronize()
        # the step's own peak: above what was allocated when it began
        peak = torch.cuda.max_memory_allocated(dev) - start
        recomputed = sum(r.recompute for r in routes)
        if name == "plain":
            l0, gr0 = float(loss.detach()), grads_of(dmodel)
            runs[name] = {"peak_memory_bytes": peak, "loss": l0}
        else:
            runs[name] = {"peak_memory_bytes": peak,
                          "loss": float(loss.detach()),
                          **against(float(loss.detach()),
                                    grads_of(dmodel), l0, gr0)}
        runs[name]["recomputed_convs"] = recomputed
    remat_d, control_d = runs["remat"], runs["control"]
    within = all(remat_d[k] <= max(control_d[k], 1e-6)
                 for k in ("loss_rel_err", "grad_rel_rms_median",
                           "grad_rel_rms_max"))
    rec_d = {"remat_compare": runs, "params_with_grad": len(gr0),
             "unet_params": sum(p.numel() for p in dmodel.parameters()),
             "within_control": within}
    emit(rec_d)
    need(within and remat_d["recomputed_convs"] > 0 and len(gr0) == sum(
        1 for _ in dmodel.parameters()), "remat: the step within the "
        "rounding control of the plain step")
    del runs, gr0
    unet.remat = True
    dmodel.zero_grad(set_to_none=True)
    dstate = mp.train.TrainState(dmodel, mp.train.adafactor_diffusion_optimizer(
        dmodel.parameters(), 2e-4, 100, 15000))
    before = {n: p.detach().clone() for n, p in dmodel.named_parameters()}
    dstep = mp.train.make_train_step(dloss)
    ada_recs = run_steps("remat_adafactor", lambda: dstep(
        dstate, batch, timesteps=t, noise=dnoise), 2, dmodel, on=())
    moved = sum(not torch.equal(p, before[n])
                for n, p in dmodel.named_parameters())
    finite = all(bool(torch.isfinite(p).all()) for p in dmodel.parameters())
    emit({"remat_adafactor_params_moved": moved,
          "params": len(before), "weights_finite": finite,
          "lr_per_update": [dstate.optimizer.schedule(i) for i in range(2)]})
    need(moved > 0 and finite, "remat + Adafactor: finite weights that move")
    # phase 3 of e2e_generalize on (a)'s VAE and this UNet: one round of
    # template-free samples (DDPM, STEPS steps) and its metrics against
    # the batch's shapes (train) and 4 val shapes
    t0 = time.perf_counter()
    sout = tg.generate_canvas(
        vae, unet, sample, tg.build_input(batch, device=dev, **sizes).grid,
        batch_size=BATCH, resolution=RES, latent_channels=VAE_CH[-1],
        vae_scale=VAE_SCALE, sample_steps=STEPS, seed=100)
    sets = tg.voxel_sets(sout)
    gen_sets = [sets.get(j, set()) for j in range(BATCH)]
    val_ds = mp.data.ProceduralShapes(
        resolution=RES, num_samples=BATCH, points_per_shape=CANVAS_POINTS,
        seed=0, composite_prob=0.25, split="val")
    m = tg.generation_metrics(gen_sets, [ds[i]["coords"] for i in range(
        BATCH)], [val_ds[i]["coords"] for i in range(BATCH)], RES)
    emit({"phase3": {k: v for k, v in m.items()},
          "phase3_s": time.perf_counter() - t0,
          "finite": bool(torch.isfinite(sout.features).all())})
    need(bool(torch.isfinite(sout.features).all()) and
         m["counts"] == [len(g) for g in gen_sets] and
         0.0 <= m["gen_size_valid_frac"] <= 1.0 and
         0.0 <= m["gen_nearest_train_iou_max"] <= 1.0 and
         0.0 <= m["gen_nearest_val_iou_mean"] <= 1.0,
         "phase 3: template-free samples and their metrics")
    del dstate, dstep, dmodel, unet, before, vae, sout
    torch.cuda.empty_cache()
    launches_d = {k: c.launches for k, c in count.items()}

    # (e) train.diffusion with noise points and remat, brick gate on
    cfg = td.parse_args(DIFF_FLAGS + ["--remat", "--noise_point_mode",
                                      "uniform", "--noise_near"])
    run = td.setup(cfg, dev)
    ds_e = mp.data.SyntheticShapes(resolution=cfg.resolution, num_samples=256)
    cpad, valid, _, _ = mp.data.collate_pointclouds(
        [ds_e[i]["coords"] for i in range(cfg.batch_size)],
        cfg.input_capacity, cfg.max_batch_len)
    gen_e = torch.Generator(device=dev).manual_seed(4)
    torch.cuda.reset_peak_memory_stats(dev)
    mp.ops.enable_brick_conv(True)
    try:
        np_recs = run_steps("noise_points", lambda: run.step_fn(
            run.state, (cpad, valid), gen_e), 2, run.model, on=KERNELS)
    finally:
        mp.ops.enable_brick_conv(False)
    peak_np = torch.cuda.max_memory_allocated(dev)
    need(all(r["recomputed_convs"] > 0 for r in np_recs) and
         np_recs[0]["launches"]["B5"] > 0 and np_recs[0]["launches"]["B6"]
         > 0, "noise points: the remat step runs the brick kernels")
    del run
    torch.cuda.empty_cache()
    launches = {k: c.launches for k, c in count.items()}
    walls = {label: [r["wall_s"] for r in recs]
             for label, recs in (("canvas_vae", vae_recs),
                                 ("canvas_vae_bf16", bf16_recs),
                                 ("cond_canvas_diffusion", cond_recs),
                                 ("remat_adafactor", ada_recs),
                                 ("noise_points", np_recs))}
    rec = {"canvas_train_path_launches": launches, "card": power,
           "launches_by_part": {"a": launches_a, "b_minus_a": {
               k: launches_b[k] - launches_a[k] for k in launches},
               "c_minus_b": {k: launches_c[k] - launches_b[k]
                             for k in launches},
               "d_minus_c": {k: launches_d[k] - launches_c[k]
                             for k in launches},
               "e_minus_d": {k: launches[k] - launches_d[k]
                             for k in launches}},
           "wall_s": walls,
           "wall_s_median_canvas_vae_steps_2_on": wall_vae,
           "wall_s_median_canvas_vae_bf16_steps_2_on": wall_bf16,
           "wall_s_median_cond_steps_2_on": wall_cond,
           "device_busy_share_cond_step": prof_cond["device_busy_share"],
           "device_busy_share_canvas_vae_fp32":
               prof32["device_busy_share"],
           "device_busy_share_canvas_vae_bf16":
               prof16["device_busy_share"],
           "elementwise_device_s_fp32": prof32["elementwise_s"],
           "elementwise_device_s_bf16": prof16["elementwise_s"],
           "peak_memory_bytes": {"canvas_vae": peak_vae,
                                 "canvas_vae_bf16": peak_bf16,
                                 "cond_canvas_diffusion": peak_cond,
                                 "noise_points": peak_np},
           "failures": failures}
    emit(rec)
    out.update(ok=not failures, failures=failures, launches=launches,
               record=rec, vae_steps=len(vae_recs))
    return out


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
    (``bound_ms``), with B7's
    products as the kernel forms them on the tensor cores
    (``bound_split_ms``: 3 bf16 products on bf16 features, 6 on float32)
    and as float32 FMAs (``bound_fp32_ms``)."""
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
    source = oc.SOURCES[kernel != "B4"]
    ta, tb = oc.MAP_TERMS[source][f.dtype]
    products = sum(a + b <= 2 for a in range(ta) for b in range(tb))
    nbytes = map_conv_bytes(w, f)
    rec = timed_check(
        kernel, w.name, "k3s1", run, plain, w.pairs, cin, cout, nbytes,
        fp32_flops=kernel != "B4", extra_ok=same and dev_ms > 0,
        n_out=nbr.shape[1], n_in=f.shape[0], k=nbr.shape[0],
        dtype=str(f.dtype), terms=[ta, tb], products=products,
        tile=list(oc.tile_shape(cin, cout, (ta, tb))),
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
           "tile": list(oc.tile_shape(k.shape[1], k.shape[2], terms)),
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
    - B4 at float32 compute launches B7's float32 instantiation: on each
      workload it must count one B4 launch and equal B7 bit for bit
      (reported with B7's kernel entry, not timed again).
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

    # B4 at float32 compute on the same workloads, counted from 0: it
    # launches B7's float32 instantiation, so it must count as B4 and equal
    # B7 bit for bit (B7's checks below time and hold that kernel)
    oc.onehot_sparse_conv.launches = 0
    b4_f32_equal = all(torch.equal(
        oc.onehot_sparse_conv(w.features, w.kernel, w.nbr, torch.float32),
        pc.pallas_sparse_conv(w.features, w.kernel, w.nbr))
        for w in ws.values())
    torch.cuda.synchronize()
    b4_f32 = {"launches_as_b4": oc.onehot_sparse_conv.launches,
              "equal_to_b7": b4_f32_equal}
    emit({"library_path_b4_float32": b4_f32})
    if b4_f32 != {"launches_as_b4": len(ws), "equal_to_b7": True}:
        failures.append("B4 at float32: B7's kernel, counted as B4")

    recs = {(n, "library"): {} for n in ("B1", *LIBRARY_KERNELS)}
    for w in ws.values():
        for kernel in ("B4", "B7"):
            recs[(kernel, "library")][w.name] = check_map_conv(mp, kernel, w)
    # B7 on bf16 features (not on the path, which builds float32 ones)
    b7_bf16 = check_map_conv(mp, "B7", ws["wide"], torch.bfloat16)
    rows = [r for n in ("B4", "B7")
            for r in recs[(n, "library")].values()]
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
            "launches": launches, "b4_f32": b4_f32}


# -- the unbounded-grid phase -----------------------------------------------
# the plain route on an unbounded grid against B1 on its bounded twin: the
# same bf16 operands and float32 sums in another order
UNBOUNDED_RTOL, UNBOUNDED_ATOL = 1e-3, 1e-5
# the api_demo's counts that do not depend on its random weights, as
# `examples/api_demo.py` prints them
API_DEMO_COUNTS = {"input": 199, "strided": 64, "grown": 512, "field": 199,
                   "dense": 199}


def unbounded_phase(mp, dev, cap, power, sizes=None) -> dict:
    """Unbounded grids and the tensor API on the library path's room
    (26,098 points, 3→32) and finest level (131,072 rows, 32→32), seed 0,
    each beside its bounded twin (the same points with the extent set):

    - (a) voxelize: the room as a ``TensorField`` with ``extent=None``
      (its points jittered inside their voxels), the finest level by
      ``make_grid(..., extent=None)``; the voxel sets must equal the
      twin's.
    - (b) the hash route (``grid_lookup`` on the card) must equal the
      sorted search on the same card over the k3 kernel map, row for row
      (every coordinate lies inside Morton's ±512-cell range).
    - (c) a k3 ``SparseConv`` on the unbounded grid (the plain route) and
      on the twin (B1) must agree per coordinate within
      1e-3·max|ref| + 1e-5; then a k2-s2 strided conv, a
      ``GenerativeConvTranspose``, ``prune`` (by coordinate parity), a
      ``+`` across two grids (the union with the points moved one voxel up
      in z) and, on the room, ``slice_to_field`` back to its points: each
      finite, with the twin's voxel counts (and the union's sums and the
      sliced features the twin's).
    - (d) ``api_demo.main`` on the card: its counts must be the example's.

    Prints per workload the hash build (ms, scatter rounds), the lookup of
    the k3 map's queries (ms, probe rounds, longest and mean probe), the
    kernel map by each route, the plain conv beside the twin's, and the
    peak memory.  B1's launches (the twins' and the demo's convs) are
    counted from 0 and their operands kept (``cap``, path "unbounded")."""
    import numpy as np
    import torch
    from mink_octtree_stablediffusion_tpu_torch import api_demo
    from mink_octtree_stablediffusion_tpu_torch import bench_conv as bc
    from mink_octtree_stablediffusion_tpu_torch.ops import hashtable
    ops, KS = mp.ops, mp.ops.KernelSpec
    k3 = bc.K3
    failures, out, all_routes = [], {}, []
    counter = counters(mp)["B1"]
    t_phase = time.perf_counter()
    ws = bc.workloads(dev, seed=0, sizes=sizes or bc.FULL)
    gen = torch.Generator(device=dev).manual_seed(11)

    def need(cond, what):
        if not cond:
            failures.append(what)

    def close(got, ref):
        err = (got - ref).abs().max().item() if ref.numel() else 0.0
        tol = UNBOUNDED_RTOL * ref.abs().max().item() + UNBOUNDED_ATOL
        return {"max_abs_err": err, "tol": tol, "ok": err <= tol}

    def twin_rows(twin, grid):
        """Each row of ``grid`` in ``twin`` (-1 where absent)."""
        return ops.grid_lookup(twin, grid.coords, grid.valid).long()

    def same_features(a, ta):
        """Per coordinate: ``a``'s rows against the twin ``ta``'s."""
        rows = twin_rows(ta.grid, a.grid)
        v = a.valid
        need(bool((rows[v] >= 0).all()), "a row missing from the twin")
        return close(a.features[v], ta.features[rows[v].clamp(min=0)])

    mp.utils.resolve_device(dev)  # float32 products without TF32
    path_launches = 0  # B1's launches by the phase's path, timing left out
    for name in ("room", "finest"):
        w = ws[name]
        coords, valid, pf, batch, extent = w.raw
        n_cap = coords.shape[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = {"unbounded_workload": name, "card": power,
               "points": int(valid.sum()), "rows": n_cap}
        # (a) voxelize, unbounded and bounded
        if name == "room":
            jitter = torch.rand(coords.shape[0], 3, generator=gen,
                                device=dev) * 0.999
            pts = torch.cat([coords[:, :1].float(),
                             coords[:, 1:].float() + jitter], 1)
            field = mp.TensorField(pts, pf, valid, batch_size=batch)
            x, inverse = field.sparse(n_cap, quantization_mode="sum")
            tx, tinverse = field.replace(extent=extent).sparse(
                n_cap, quantization_mode="sum")
        else:
            g, inv, _ = ops.make_grid(coords, valid, n_cap, batch_size=batch)
            tg, tinv, _ = ops.make_grid(coords, valid, n_cap,
                                        batch_size=batch, extent=extent)
            x = mp.SparseTensor(g, ops.reduce_by_inverse(pf, inv, valid,
                                                         n_cap, "sum"))
            tx = mp.SparseTensor(tg, ops.reduce_by_inverse(pf, tinv, valid,
                                                           n_cap, "sum"))
        need(x.grid.extent is None and tx.grid.extent is not None,
             f"{name}: grid bounds")
        rec["voxels"] = int(x.count())
        need(voxel_set(x.grid.coords, x.grid.valid) ==
             voxel_set(tx.grid.coords, tx.grid.valid), f"{name}: voxel sets")
        rec["features_vs_twin"] = same_features(x, tx)
        # (b) the hash route against the sorted search on the card
        grid = x.grid
        rec["route"] = ops.lookup_route(grid, dev)
        need(rec["route"] == "hash", f"{name}: the card takes the hash route")
        nbr = ops.kernel_map(grid, grid, k3)
        rec["matched_pairs"] = int((nbr >= 0).sum())
        need(rec["matched_pairs"] == int((ops.kernel_map(
            tx.grid, tx.grid, k3) >= 0).sum()), f"{name}: pairs vs twin")
        # the k3 map's queries, as kernel_map builds them
        table = grid.hash_table()
        offs = k3.absolute_offsets(grid.stride)
        deltas = torch.as_tensor(offs, dtype=torch.int32, device=dev)
        queries = torch.cat([grid.coords[None, :, :1].expand(len(offs), -1, 1),
                             grid.coords[None, :, 1:] + deltas[:, None]],
                            -1).reshape(-1, 4)
        qv = grid.valid.repeat(len(offs))

        def sorted_rows():
            return ops.lookup_sorted(grid.coords, grid.valid, grid.stride,
                                     queries, qv)
        rec["kernel_map_hash_equals_sorted"] = bool(torch.equal(
            nbr.reshape(-1), sorted_rows()))
        need(rec["kernel_map_hash_equals_sorted"], f"{name}: hash vs sorted")
        rows, probe_rounds, probes = hashtable.probe(table, queries, qv)
        need(bool(torch.equal(rows.reshape(nbr.shape), nbr)),
             f"{name}: probe vs kernel map")
        rec.update({
            "table_size": table.table_size,
            "load": int(grid.valid.sum()) / table.table_size,
            "hash_build_ms": bc.cuda_time_ms(lambda: hashtable.build_table(
                grid.coords, grid.valid)),
            "hash_build_rounds": table.rounds,
            "lookup_queries": int(qv.sum()),
            "lookup_ms": bc.cuda_time_ms(lambda: hashtable.lookup(
                table, queries, qv)),
            "lookup_probe_rounds": probe_rounds,
            "lookup_longest_probe": int(probes.max()),
            "lookup_mean_probe": float(probes[qv].float().mean()),
            # a fresh grid object: the table is built inside each call
            "kernel_map_ms_hash_with_build": bc.cuda_time_ms(
                lambda: ops.kernel_map(ops.SparseGrid(
                    grid.coords, grid.valid, grid.stride, grid.batch_size),
                    grid, k3)),
            "lookup_ms_sorted": bc.cuda_time_ms(sorted_rows),
            "kernel_map_ms_twin_lut": bc.cuda_time_ms(
                lambda: ops.kernel_map(tx.grid, tx.grid, k3))})
        del queries, qv, rows, probes
        # (c) the conv family, unbounded (plain) against the twin (B1)
        cin, cout = w.kernel.shape[1], w.kernel.shape[2]
        conv = mp.nn.SparseConv(cin, cout, 3, device=dev)
        down = mp.nn.SparseConv(cout, cout, 2, 2, device=dev)
        # room enough that no buffer overflows: an overflowing buffer keeps
        # the first rows of its canonical order, which differs between the
        # two grids
        up = mp.nn.GenerativeConvTranspose(cout, cout,
                                           out_capacity=8 * n_cap,
                                           device=dev)
        for m in (conv, down, up):
            m.reset_parameters(generator=gen)
        cap.at("unbounded", ("B1",))
        counter.launches = 0
        with torch.no_grad(), mp.nn.record_routes() as routes:
            y, ty = conv(x), conv(tx)
            rec["conv_vs_twin"] = same_features(y, ty)
            z, tz = down(y), down(ty)
            g_up, tg_up = up(z), up(tz)
            keep = (torch.div(g_up.C[:, 1], g_up.tensor_stride[0],
                              rounding_mode="floor") % 2 == 0)
            tkeep = (torch.div(tg_up.C[:, 1], tg_up.tensor_stride[0],
                               rounding_mode="floor") % 2 == 0)
            pruned = mp.SparseTensor(*ops.prune(g_up.grid, g_up.features,
                                                keep))
            tpruned = mp.SparseTensor(*ops.prune(tg_up.grid, tg_up.features,
                                                 tkeep))
            up_z = coords.clone()
            up_z[:, 3] += 1
            up_valid = valid & (up_z[:, 3] < extent[2])
            g2, _, _ = ops.make_grid(up_z, up_valid, 2 * n_cap,
                                     batch_size=batch)
            tg2, _, _ = ops.make_grid(up_z, up_valid, 2 * n_cap,
                                      batch_size=batch, extent=extent)
            ones = torch.ones(2 * n_cap, cout, device=dev)
            u = y + mp.SparseTensor(g2, ones * g2.valid[:, None])
            tu = ty + mp.SparseTensor(tg2, ones * tg2.valid[:, None])
            rec["union_vs_twin"] = same_features(u, tu)
            steps = {"conv": (y, ty), "strided": (z, tz),
                     "generative": (g_up, tg_up), "pruned": (pruned, tpruned),
                     "union": (u, tu)}
            if name == "room":
                s, ts = (mp.slice_to_field(y, field, inverse),
                         mp.slice_to_field(ty, field, tinverse))
                rec["sliced_points"] = int(s.valid.sum())
                need(rec["sliced_points"] == w.points, "room: sliced points")
                rec["slice_vs_twin"] = close(s.features, ts.features)
                need(bool(torch.isfinite(s.features).all()), "room: slice")
                need(rec["slice_vs_twin"]["ok"], "room: slice vs twin")
        cap.at(None)
        torch.cuda.synchronize()
        path_launches += counter.launches
        all_routes += routes
        rec["voxel_counts"] = {k: [int(a.count()), int(b.count())]
                               for k, (a, b) in steps.items()}
        for k, (a, b) in steps.items():
            need(int(a.count()) == int(b.count()) > 0 and
                 int(a.count()) < a.capacity,
                 f"{name}: {k} voxel count vs twin, no overflow")
            need(bool(torch.isfinite(a.features).all()), f"{name}: {k} finite")
        need(rec["features_vs_twin"]["ok"] and rec["conv_vs_twin"]["ok"] and
             rec["union_vs_twin"]["ok"], f"{name}: features vs twin")
        rec["branches"] = {"unbounded": sorted({
            r.branch for r in routes[0::2]}), "twin": sorted({
                r.branch for r in routes[1::2]})}
        need(rec["branches"]["unbounded"] == ["plain"] and
             "fused" in rec["branches"]["twin"], f"{name}: conv routes")
        with torch.no_grad():
            rec["plain_conv_ms"] = bc.cuda_time_ms(lambda: conv(x))
            rec["twin_b1_conv_ms"] = bc.cuda_time_ms(lambda: conv(tx))
        torch.cuda.synchronize()
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        emit(rec)
        out[name] = rec
        del x, tx, y, ty, z, tz, g_up, tg_up, pruned, tpruned, u, tu, steps
        torch.cuda.empty_cache()
    # (d) the api_demo entry point on the card
    cap.at("unbounded", ("B1",))
    counter.launches = 0
    with mp.nn.record_routes() as routes:
        counts = api_demo.main(["--device", str(dev)])
    cap.at(None)
    torch.cuda.synchronize()
    path_launches += counter.launches
    all_routes += routes
    emit({"api_demo_counts": counts, "card": power})
    need(all(counts[k] == v for k, v in API_DEMO_COUNTS.items()) and
         counts["pruned"] > 0, "api_demo counts")
    launches = path_launches
    fused = sum(r.branch == "fused" for r in all_routes)
    emit({"unbounded_path_launches": {"B1": launches},
          "fused_route_convs": fused,
          "phase_s": time.perf_counter() - t_phase})
    need(launches == fused > 0, "B1 launches on the unbounded path")
    del ws
    torch.cuda.empty_cache()
    return {"ok": not failures, "failures": failures, "records": out,
            "routes": all_routes, "launches": {"B1": launches}}


# -- the model zoo ------------------------------------------------------------
# The five training entry points at their examples' full-width defaults,
# ZOO_STEPS steps each on one fixed batch from seed 0 (one step each of the
# splat classifier and the TensorField PointNet), then train.cond's oracle
# and scoring cut to ZOO_COND_FLAGS.
ZOO_STEPS = 3
ZOO_SIZES = {"cls": dict(resolution=64, batch=8, points=2048),
             "seg": dict(resolution=32, batch=2, voxels=2048),
             "recon": dict(resolution=64, batch=4, capacity=65536,
                           points=32768),
             "dense": dict(resolution=32, batch=2, channels=(32, 64, 128))}
ZOO_COND_FLAGS = ["--train_shapes", "8", "--val_shapes", "4",
                  "--oracle_shapes", "16", "--steps_cls", "3",
                  "--steps_diff", "2", "--cfg_scales", "3", "--rounds", "1"]
# tiny_zoo_reference's narrow MinkUNet14
ZOO_TINY_PLANES, ZOO_TINY_INIT = (8, 16, 16, 16, 16, 16, 8, 8), 8


def zoo_phase(mp, dev, cap, power) -> dict:
    """The model zoo's training paths, each through its entry point's own
    model, loss and optimizer builders, with the kernels' counts at 0:

    a. classification (`train.classification`): resolution 64, batch 8 of
       `SyntheticShapes` (samples 0-7), 2,048 points a shape, voxel size
       0.05, Adam at 1e-3: ``MinkowskiFCNN`` (a 16,384-row voxel buffer)
       ZOO_STEPS steps, then its held-out accuracy on 8 shapes in
       ``.eval()``; one step each of ``MinkowskiSplatFCNN`` (its convs on
       an unbounded grid take the plain route) and ``MinkowskiPointNet``
       (no conv).
    b. segmentation (`train.segmentation`): MinkUNet34C, resolution 32,
       batch 2 rooms of 2,048 voxels (``make_room`` from RandomState(42)),
       Adam at 1e-3, ZOO_STEPS steps; its k5 stem is the K = 125 launch.
       The stride-2 and stride-4 levels overflow their 512 and 64 rows
       (the reference behaviour, ROADMAP.md §C): printed.
    c. reconstruction (`train.reconstruction`): ``GenerativeNet`` at
       (1024, 512, 256, 128, 64, 32), resolution 64, batch 4 (32,768
       points a shape, 65,536 rows), SGD with momentum 0.9 at 1e-2,
       ZOO_STEPS steps, then the eval-mode generation IoU on the 4
       held-out shapes.
    d. the VQ-VAE (`train.vqvae`): the VAE's widths (32, 128, 512, 512,
       4), 512 codes, resolution 128, batch 4, 65,536 rows, Adam at 1e-3,
       ZOO_STEPS steps.  The encoder's log-variance head has no gradient
       (the VQ-VAE does not use it).
    e. dense diffusion (`train.diffusion_dense`): resolution 32, batch 2,
       (32, 64, 128), ZOO_STEPS steps without and with ``--with_cond``
       (cuDNN convolutions: no kernel of the port).
    f. ``train.cond``'s oracle, conditional diffusion and per-class
       scoring at its defaults (resolution 64, batch 4, VAE (32, 128, 512,
       512, 4) of random weights, UNet (4, 128, 256, 384)), cut to
       ZOO_COND_FLAGS and ``STEPS`` sampling steps.

    Every loss and gradient must be finite, every parameter must get a
    gradient, and each step's (and f's whole run's) B1/B2/B3 launches
    must equal its routes' (``expected_launches``).  ``cap`` keeps step
    1's operands of each path (paths ``zoo_*``) for the kernel checks.
    Prints each path's step walls and peak memory."""
    import tempfile
    import numpy as np
    import torch
    from mink_octtree_stablediffusion_tpu_torch.train import (
        classification as tcls, cond as tcond, diffusion_dense as tdd,
        reconstruction as trec, segmentation as tseg, vqvae as tvq)
    failures = []

    def need(ok, what):
        if not ok:
            failures.append(what)
    count = counters(mp)
    for c in count.values():
        c.launches = 0  # counts from here on are the zoo's
    out = {"routes": {}, "steps": {}}
    t_phase = time.perf_counter()

    def run_path(label, model, step, n, no_grad=()):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        recs = []
        for i in range(n):
            cap.at(label, FUSED if i == 0 else ())
            before = {k: c.launches for k, c in count.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mp.nn.record_routes() as routes:
                loss, aux = step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cap.at(None)
            launched = {k: c.launches - before[k] for k, c in count.items()}
            missing = [k for k, p in model.named_parameters()
                       if p.grad is None and not k.startswith(no_grad)]
            finite = bool(torch.stack(
                [torch.isfinite(loss)] +
                [torch.isfinite(p.grad).all() for p in model.parameters()
                 if p.grad is not None]).all().item())
            rec = {"zoo_path": label, "step": i + 1, "wall_s": wall,
                   "loss": float(loss),
                   **{k: float(v) for k, v in aux.items()},
                   "launches": launched,
                   "expected_launches": expected_launches(routes),
                   "convs": len(routes),
                   "branches": dict(Counter(r.branch for r in routes)),
                   "ks": sorted({r.k for r in routes
                                 if r.branch == "fused"}),
                   "params_without_grad": missing[:5],
                   "all_finite": finite}
            emit(rec)
            recs.append(rec)
            need(finite and not missing, f"{label} step {i + 1}: finite "
                 "loss and a gradient for every parameter")
            need(launched == rec["expected_launches"],
                 f"{label} step {i + 1}: launches")
            if i == 0:
                out["routes"][label] = routes
        peak = torch.cuda.max_memory_allocated(dev)
        emit({"zoo_path_summary": label, "steps": n,
              "step_walls_s": [r["wall_s"] for r in recs],
              "peak_memory_bytes": peak, "card": power,
              "launches_per_step": recs[-1]["launches"]})
        out["steps"][label] = n
        return recs

    # (a) classification
    b, pts, res = (ZOO_SIZES["cls"][k] for k in ("batch", "points",
                                                  "resolution"))
    ccap, extent = b * pts, tcls.field_extent(0.05)
    ds = mp.data.SyntheticShapes(resolution=res, num_samples=256,
                                 points_per_shape=pts)
    collate = lambda samples: tcls.collate(  # noqa: E731
        samples, resolution=res, num_points=pts, voxel_size=0.05,
        capacity=ccap)
    batch = collate([ds[i] for i in range(b)])
    loss_fn = tcls.build_loss_fn(batch_size=b, extent=extent, device=dev)
    for network, n in (("minkfcnn", ZOO_STEPS), ("minksplatfcnn", 1),
                       ("pointnet", 1)):
        net = tcls.build_model(network, 4, ccap, dev, seed=0)
        state = mp.train.TrainState(net, mp.train.vae_optimizer(
            net.parameters(), 1e-3))
        step = mp.train.make_train_step(loss_fn)
        run_path(f"zoo_cls_{network}", net, lambda: step(state, batch), n)
        if network == "minkfcnn":
            ds_val = mp.data.SyntheticShapes(
                resolution=res, num_samples=b, points_per_shape=pts,
                seed=777)
            t0 = time.perf_counter()
            acc = tcls.evaluate(net, ds_val, collate, batch_size=b,
                                extent=extent, device=dev)
            emit({"zoo_cls_minkfcnn_val_acc": acc,
                  "eval_wall_s": time.perf_counter() - t0})
            need(0.0 <= acc <= 1.0, "classification evaluate")
        del net, state, step
        torch.cuda.empty_cache()

    # (b) segmentation
    b, res, vox = (ZOO_SIZES["seg"][k] for k in ("batch", "resolution",
                                                  "voxels"))
    scap = b * vox
    sbatch = tseg.collate(np.random.RandomState(42), batch_size=b,
                          resolution=res, voxels_per_room=vox)
    net = mp.models.MinkUNet34C(out_channels=3, input_capacity=scap,
                                device=dev, seed=0)
    st, _ = tseg.build(*sbatch, batch_size=b, resolution=res, device=dev)
    emit({"zoo_seg_levels": [
        {"stride": 2 ** i, "cells": int(mp.ops.stride_grid(
            st.grid, 2 ** i, scap).valid.sum()),
         "capacity": max(scap // 8 ** i, 64)} for i in (1, 2, 3, 4)],
        "input_voxels": int(st.valid.sum())})
    state = mp.train.TrainState(net, mp.train.vae_optimizer(
        net.parameters(), 1e-3))
    step = mp.train.make_train_step(tseg.build_loss_fn(
        batch_size=b, resolution=res, device=dev))
    recs = run_path("zoo_seg_minkunet34c", net,
                    lambda: step(state, sbatch), ZOO_STEPS)
    need(125 in recs[0]["ks"] and 8 in recs[0]["ks"],
         "segmentation launches K = 125 and K = 8")
    # the stem's input is data, so the step launches no dF at K = 125:
    # one pass of the stem with an input gradient launches it (B2 at the
    # stem's own geometry; B1 and B3 again)
    g = torch.Generator(device=dev).manual_seed(5)
    cot = torch.randn((st.capacity, net.conv0.out_channels), generator=g,
                      device=dev)

    def stem_df():
        net.zero_grad(set_to_none=True)
        x = st.with_features(st.features.clone().requires_grad_())
        loss = (net.conv0(x).features * cot).sum()
        loss.backward()
        return loss.detach(), {}
    run_path("zoo_seg_stem_df", net.conv0, stem_df, 1)
    del net, state, step, st
    torch.cuda.empty_cache()

    # (c) reconstruction
    b, rcap, res, pts = (ZOO_SIZES["recon"][k] for k in (
        "batch", "capacity", "resolution", "points"))
    ds = mp.data.SyntheticShapes(resolution=res, num_samples=256,
                                 points_per_shape=pts)
    samples = [ds[i] for i in range(b)]
    cpad, valid, _, _ = mp.data.collate_pointclouds(
        [s["coords"] for s in samples], rcap)
    rbatch = (cpad, valid, [s["label"] for s in samples])
    net = mp.models.GenerativeNet(
        4, level_capacities=trec.level_capacities(b, rcap), device=dev,
        seed=0)
    state = mp.train.TrainState(net, trec.make_optimizer(
        net.parameters(), "sgd", 1e-2))
    sizes = dict(n_classes=4, batch_size=b, resolution=res, device=dev)
    step = mp.train.make_train_step(trec.build_loss_fn(**sizes))
    run_path("zoo_recon", net, lambda: step(state, rbatch), ZOO_STEPS)
    ds_val = mp.data.SyntheticShapes(resolution=res, num_samples=b,
                                     points_per_shape=pts, seed=777)
    ev = [ds_val[i] for i in range(b)]
    ecpad, evalid, _, _ = mp.data.collate_pointclouds(
        [s["coords"] for s in ev], rcap)
    t0 = time.perf_counter()
    iou, sout = trec.generation_iou(net, (ecpad, evalid,
                                          [s["label"] for s in ev]), **sizes)
    torch.cuda.synchronize()
    emit({"zoo_recon_generation_iou": iou,
          "generated_voxels": int(sout.valid.sum()),
          "eval_wall_s": time.perf_counter() - t0})
    need(0.0 <= iou <= 1.0 and bool(torch.isfinite(sout.features).all()),
         "reconstruction eval generation")
    del net, state, step, sout
    torch.cuda.empty_cache()

    # (d) the VQ-VAE
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=256)
    vbatch = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(BATCH)], CAP, 200_000)[:2]
    net = tvq.build_model(vae_channel=VAE_CH, num_embeddings=512,
                          input_capacity=CAP, device=dev, seed=0)
    state = mp.train.TrainState(net, mp.train.vae_optimizer(
        net.parameters(), 1e-3))
    step = mp.train.make_train_step(tvq.build_loss_fn(
        input_capacity=CAP, batch_size=BATCH, resolution=RES, device=dev))
    run_path("zoo_vqvae", net, lambda: step(state, vbatch), ZOO_STEPS,
             no_grad=("encoder.log_var_conv.",))
    del net, state, step
    torch.cuda.empty_cache()

    # (e) dense diffusion, without and with the condition
    b, res, channels = (ZOO_SIZES["dense"][k] for k in (
        "batch", "resolution", "channels"))
    for with_cond in (False, True):
        ds = mp.data.SyntheticShapes(resolution=res, num_samples=128,
                                     with_class=with_cond)
        samples = [ds[i] for i in range(b)]
        table = tdd.class_table(4, 64)
        dbatch = (tdd.densify(samples, res), table[[s["label"] for s in
                                                    samples]]
                  if with_cond else None)
        net = tdd.build_model(block_channels=channels,
                              with_cond=with_cond, cross_attention_dim=64,
                              device=dev, seed=0)
        state = mp.train.TrainState(net, mp.train.diffusion_optimizer(
            net.parameters(), 1e-4))
        step = mp.train.make_train_step(tdd.build_loss_fn(
            mp.diffusion.DDPMScheduler.create(), with_cond=with_cond,
            device=dev))
        gen = torch.Generator(device=dev).manual_seed(0)
        run_path("zoo_dense_diffusion" + ("_cond" if with_cond else ""),
                 net, lambda: step(state, dbatch, gen), ZOO_STEPS)
        del net, state, step
        torch.cuda.empty_cache()

    # (f) train.cond's oracle, diffusion and scoring
    before = {k: c.launches for k, c in count.items()}
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        cap.at("zoo_cond", FUSED)
        t0 = time.perf_counter()
        with mp.nn.record_routes() as routes:
            res_cond = tcond.main(["--device", str(dev), "--ckpt_dir", tmp,
                                   "--sample_steps", str(STEPS)] +
                                  ZOO_COND_FLAGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cap.at(None)
    launched = {k: c.launches - before[k] for k, c in count.items()}
    sweep = res_cond["cfg_sweep"]["3.0"]
    rec = {"zoo_cond_wall_s": wall,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
           "classifier_val_acc": res_cond["classifier_val_acc"],
           "diff_loss_last": res_cond["diff_loss_last"],
           "mean_conditional_acc": sweep["mean"],
           "mean_oracle_corrected": sweep["mean_oracle_corrected"],
           "launches": launched,
           "expected_launches": expected_launches(routes),
           "convs": len(routes), "card": power}
    emit(rec)
    out["routes"]["zoo_cond"] = routes
    need(launched == rec["expected_launches"], "zoo_cond: launches")
    need(math.isfinite(res_cond["diff_loss_last"]) and
         0.0 <= res_cond["classifier_val_acc"] <= 1.0 and
         sweep["samples_per_class"] > 0, "zoo_cond: its result")
    launches = {k: c.launches for k, c in count.items()}
    emit({"zoo_path_launches": launches,
          "phase_s": time.perf_counter() - t_phase})
    need(all(launches[k] > 0 for k in FUSED), "zoo: B1, B2 and B3 launch")
    torch.cuda.empty_cache()
    return {"ok": not failures, "failures": failures, "launches": launches,
            **out}


def tiny_zoo_reference(mp, dev) -> dict:
    """One train step of a narrow MinkUNet14 (planes ZOO_TINY_PLANES, the
    segmentation batch: 2 rooms of 2,048 voxels at resolution 32, its k5
    stem) and one of a narrow VQ-VAE (widths (8, 16, 32, 32, 4), 64 codes,
    resolution 128, 4,096 rows) on the card and on the CPU, with the same
    weights and batch, the CPU's plain versions under the card's compute
    policy, held to ``tiny_train_reference``'s bounds: the loss within
    1e-2 relative, every gradient's relative RMS ≤ TINY_GRAD_RTOL and
    every running statistic's update's ≤ TINY_STAT_RTOL (the VQ-VAE's
    unused log-variance head has no gradient on either side).

    The VQ-VAE's CPU side quantizes with the card's code indices: the
    argmin over the codes has near-ties that the two sides' bf16
    rounding decides differently (on the H100, from U(−1/K, 1/K) codes and
    from N(0, 1) codes alike, a few rows took another code), and a row on
    another code moves the decoder's pruning, and so most gradients, far
    beyond the bounds (median relative RMS 0.12–0.13).  The quantizer's
    arithmetic is the same with either index set; the record counts the
    valid rows where the CPU's own argmin differs, and at most
    TINY_CODES_RTOL of them may.  Its codebook is drawn N(0, 1), the scale
    of the latents."""
    import numpy as np
    import torch
    from mink_octtree_stablediffusion_tpu_torch.train import (
        segmentation as tseg, vqvae as tvq)
    sbatch = tseg.collate(np.random.RandomState(42), batch_size=2,
                          resolution=32, voxels_per_room=2048)

    def pinned_codes(card_codes, seen, valid_rows):
        """A forward hook on the quantizer: records its own indices and
        valid rows and, given ``card_codes``, quantizes with those instead
        (through the quantizer's own ``quantize``)."""
        def hook(m, inputs, out):
            seen.append(out[1].cpu())
            valid_rows.append(inputs[0].valid.cpu())
            if card_codes is None:
                return None
            return m.quantize(inputs[0], card_codes.to(out[1].device))
        return hook

    def spread_book(net):
        with torch.no_grad():
            net.vq.embedding.copy_(torch.randn(
                net.vq.embedding.shape,
                generator=torch.Generator().manual_seed(4)))
        return net
    ds = mp.data.SyntheticShapes(resolution=128, num_samples=2,
                                 points_per_shape=1500)
    vbatch = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(2)], 4096)[:2]
    cases = {
        "minkunet14": (
            lambda d: mp.models.MinkUNet14(
                3, planes=ZOO_TINY_PLANES, init_dim=ZOO_TINY_INIT,
                input_capacity=4096, device=d, seed=3),
            lambda d: tseg.build_loss_fn(batch_size=2, resolution=32,
                                         device=d), sbatch),
        "vqvae": (
            lambda d: spread_book(tvq.build_model(
                vae_channel=(8, 16, 32, 32, 4), num_embeddings=64,
                input_capacity=4096, device=d, seed=3)),
            lambda d: tvq.build_loss_fn(input_capacity=4096, batch_size=2,
                                        resolution=128, device=d), vbatch)}
    recs, ok = {}, True
    mp.ops.set_default_compute_dtype(torch.bfloat16)
    try:
        for name, (make, make_loss, batch) in cases.items():
            got, codes, valid_rows = [], [], []
            ref_state = None
            for d in (dev, torch.device("cpu")):  # the card's codes first
                net = make(d)
                if ref_state is None:  # before the step moves them
                    ref_state = {k: v.clone()
                                 for k, v in net.state_dict().items()}
                else:
                    net.load_state_dict(ref_state)
                old = {n: t.clone() for n, t in net.named_buffers()}
                state = mp.train.TrainState(net, mp.train.vae_optimizer(
                    net.parameters(), 1e-3))
                hook = (net.vq.register_forward_hook(
                    pinned_codes(codes[0] if codes else None, codes,
                                 valid_rows))
                    if name == "vqvae" else None)
                loss, _ = mp.train.make_train_step(make_loss(d))(state,
                                                                 batch)
                if hook is not None:
                    hook.remove()
                got.append((float(loss),
                            {n: p.grad.cpu() for n, p in
                             net.named_parameters() if p.grad is not None},
                            {n: (t - old[n]).float().cpu() for n, t in
                             net.named_buffers()
                             if t.is_floating_point()}))
            (lg, gg, sg), (lc, gc, sc) = got
            grad_rel, stat_rel = rel_rms(gg, gc), rel_rms(sg, sc)
            worst_g = max(grad_rel, key=grad_rel.get)
            worst_s = max(stat_rel, key=stat_rel.get)
            loss_rel = abs(lg - lc) / abs(lc)
            # the card's argmin against the CPU's, over the valid rows
            differing = (int(((codes[0] != codes[1]) & valid_rows[0]).sum())
                         if codes else None)
            n_valid = int(valid_rows[0].sum()) if codes else None
            rec = {"tiny_zoo_reference": name,
                   "vs": "cpu, same bf16 policy", "loss_cpu": lc,
                   "loss_gpu": lg, "loss_rel_err": loss_rel,
                   "grads_compared": len(grad_rel),
                   "same_grads": set(gg) == set(gc),
                   "grad_rel_rms_max": grad_rel[worst_g],
                   "grad_worst": worst_g,
                   "grad_rel_rms_median": statistics.median(
                       grad_rel.values()),
                   "stat_update_rel_rms_max": stat_rel[worst_s],
                   "stat_worst": worst_s,
                   "tol": {"grad": TINY_GRAD_RTOL, "stat": TINY_STAT_RTOL},
                   "codes_differing": differing,
                   "valid_rows": n_valid,
                   "codes_tol": TINY_CODES_RTOL,
                   "ok": bool(loss_rel <= 1e-2 and set(gg) == set(gc) and
                              grad_rel[worst_g] <= TINY_GRAD_RTOL and
                              stat_rel[worst_s] <= TINY_STAT_RTOL and
                              (differing is None or differing <=
                               TINY_CODES_RTOL * n_valid))}
            emit(rec)
            recs[name] = rec
            ok = ok and rec["ok"]
    finally:
        mp.ops.set_default_compute_dtype(None)
    return {"ok": ok, "records": recs}


# -- the data-parallel phase ------------------------------------------------
# Two ranks share the one card over gloo (NCCL refuses two ranks on one
# device; gloo's all_reduce and broadcast take CUDA tensors through the
# host), DP_BATCH shapes a rank: the global batch of 4 of the
# single-process paths.  A rank that stops answering fails the phase after
# DP_TIMEOUT_S.
DP_RANKS, DP_BATCH, DP_TIMEOUT_S = 2, 2, 300
# (DP_DIFF_STEPS 2 until the quality phase needed the time: a step takes
# 6-8 s of host all-reduce; DP_VAE_STEPS 3 until the tensor-parallel phase)
DP_VAE_STEPS, DP_DIFF_STEPS, DP_RESNET_STEPS = 2, 1, 2
# -- the tensor-parallel phase ----------------------------------------------
# Four ranks share the card over gloo as a 2 x 2 (data, model) mesh,
# TP_BATCH shapes a data row; TP_STEPS steps on distinct batches after the
# same-batch step.  The warmup is 0 (lr 1e-4 from the first update), so
# that every step moves the parameters whose replicas are compared.
TP_RANKS, TP_BATCH, TP_STEPS = 4, 2, 1
TP_FLAGS = ["--warmup", "0"]
# The same-batch step's bound: each of its distances from one process's
# step (the loss's relative difference, the gradients' relative RMS at the
# median and the worst tensor) within TP_CONTROL_FACTOR times the larger of
# two rounding controls' (the noise rounded to bf16; the noise moved by
# 2^-20 of itself).  On the H100 (80GB HBM3, 700 W) the dp x tp step read
# 6.1e-4, 0.068, 0.65 against 9.4e-5, 0.071, 0.53 and 4.2e-4, 0.070,
# 0.69: the bf16 UNet answers any change of a sum's order with bf16
# rounding flips (the dense route's cuDNN convs round their outputs to
# bf16 and choose other algorithms at Cout/2; with that route off the step
# read 4.0e-4 against controls of 1.4e-3 and 8.9e-4), and a loss is one
# draw of that answer.  A wrong transpose moves the gradients by O(1).
TP_CONTROL_FACTOR = 2.0
# the earlier paths whose operands main() checks at every launch shape, and
# their kernels: the DP ranks send back only the shapes not among them
# the data phase (``data_phase``): a ModelNet40-layout tree of tori of
# 2·100·50 = 10,000 faces, 2 classes × (4 train + 2 test); the steps of
# each entry point it drives
DATA_CLASSES, DATA_TRAIN, DATA_TEST, DATA_NU, DATA_NV = \
    ("airplane", "chair"), 4, 2, 100, 50
DATA_VAE_STEPS, DATA_CLS_STEPS, DATA_STREAM_STEPS, DATA_PREFETCH = 3, 2, 3, 4
# procedural_batch's and the native voxelizer's size: 4 shapes of 32,768
# points at resolution 128 into 65,536 rows
DATA_SHAPES, DATA_POINTS = 4, 32768
# extra flags of each entry point the phase drives (none on the card: the
# entry points' defaults; a CPU rehearsal appends its tiny sizes)
DATA_FLAGS = {"data_vae": [], "data_cls": [], "data_stream": []}


def data_phase(mp, dev, cap, power) -> dict:
    """The data path and the utilities on the card, each path with the
    kernels' counts read around it:

    a. mesh files: a ModelNet40-layout tree of OFF meshes (DATA_CLASSES
       × DATA_TRAIN train + DATA_TEST test tori of 10,000 faces), an OBJ
       tree and a GLB file (a strided accessor), each read through its
       dataset (`ModelNet40Dataset`, `ShapeNetDataset`,
       `ObjaverseDataset`) at resolution 128.
    b. ``train.vae --data <tree> --cache_dir`` at its defaults (VAE (32,
       128, 512, 512, 4), resolution 128, batch 4, 65,536 rows, rotation
       augmentation) for DATA_VAE_STEPS steps: 8 meshes, 2 batches an
       epoch, so step 3 reads the npy cache; each mesh file is parsed
       once.
    c. ``train.classification --data <tree>`` (MinkowskiFCNN, resolution
       64, batch 8, 40 classes) for DATA_CLS_STEPS steps, then its score
       on the test split.
    d. ``train.generalize --stream_device``, phase 1 only, at its
       defaults (the canvas VAE, resolution 64, 32,768 points a shape) for
       DATA_STREAM_STEPS steps, each batch from `data.procedural_batch`.
    e. DATA_PREFETCH batches of the mesh tree fed to `train.vae`'s step
       (the same VAE) through `PrefetchLoader` (pinned host memory, a side
       stream): each batch on the card equal to its host arrays.
    f. ``native.*`` (the C++ library, built at first use on this host)
       equal to the plain paths on the xyz of 4 of the tree's shapes
       (32,768 points each), both timed.
    g. ``procedural_batch`` at resolution 128 (DATA_SHAPES shapes of
       DATA_POINTS points, 65,536 rows) with no host synchronization
       inside (``torch.cuda.set_sync_debug_mode``), timed against a host
       `ProceduralShapes` batch of the same size.
    h. ``utils.backend_selfcheck`` and ``backend_differential_suite`` on
       the card (B1 as its fused conv), each op's ``max_err`` printed.

    Every step's loss must be finite and each path's B1/B2/B3 launches
    must equal its routes' (``expected_launches``); ``cap`` keeps the
    operands of each launch shape of paths ``data_*`` for the kernel
    checks.  Every failure is fatal."""
    import itertools
    import os
    import shutil
    import tempfile
    import warnings
    import numpy as np
    import torch
    from mink_octtree_stablediffusion_tpu_torch import native
    from mink_octtree_stablediffusion_tpu_torch.data import datasets as dsm
    from mink_octtree_stablediffusion_tpu_torch.data import mesh_files
    from mink_octtree_stablediffusion_tpu_torch.train import (
        classification as tcls, generalize as tgen, vae as tvae)
    failures = []

    def need(ok, what):
        if not ok:
            failures.append(what)
    count = counters(mp)
    for c in count.values():
        c.launches = 0  # counts from here on are the data phase's
    out = {"routes": {}, "launches": {}}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        # (a) the mesh files and their datasets
        root = os.path.join(tmp, "modelnet")
        t0 = time.perf_counter()
        mesh_files.write_modelnet_tree(root, DATA_CLASSES, DATA_TRAIN,
                                       DATA_TEST, DATA_NU, DATA_NV, seed=0)
        obj_root = os.path.join(tmp, "shapenet")
        mesh_files.write_modelnet_tree(obj_root, DATA_CLASSES, 1, 0,
                                       DATA_NU, DATA_NV, seed=1, ext=".obj")
        glb_dir = os.path.join(tmp, "objaverse")
        os.makedirs(glb_dir)
        v, f = mesh_files.torus_mesh(DATA_NU, DATA_NV)
        mesh_files.write_glb(os.path.join(glb_dir, "uid0.glb"), v, f,
                             stride=16)
        write_s = time.perf_counter() - t0
        reads = {}
        for name, ds in (
                ("modelnet40", mp.data.ModelNet40Dataset(root, "train", RES)),
                ("shapenet", mp.data.ShapeNetDataset(obj_root,
                                                     resolution=RES)),
                ("objaverse", mp.data.ObjaverseDataset(glb_dir, RES))):
            t0 = time.perf_counter()
            sample = ds[0]
            reads[name] = {"files": len(ds), "read_s":
                           time.perf_counter() - t0,
                           "points": len(sample["xyz"]),
                           "voxels": len(sample["coords"])}
            xyz = sample["xyz"]
            need(len(ds) > 0 and len(sample["coords"]) > 0 and
                 xyz.min() >= 0 and xyz.max() < RES,
                 f"{name}: a sample in [0, {RES})")
        need(reads["modelnet40"]["files"] == len(DATA_CLASSES) * DATA_TRAIN,
             "modelnet40: the train split's files")
        emit({"data_files": reads, "write_s": write_s,
              "faces_per_mesh": 2 * DATA_NU * DATA_NV})

        def entry(label, module, argv):
            """``module.main(argv)`` with its step walls and losses, its
            routes and its launches."""
            walls, losses = [], []
            orig = module.make_train_step

            def make(loss_fn):
                step = orig(loss_fn)

                def timed(*a, **k):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    loss, aux = step(*a, **k)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    losses.append(float(loss))
                    return loss, aux
                return timed
            module.make_train_step = make
            before = {k: c.launches for k, c in count.items()}
            cap.at(label, FUSED)
            try:
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                with mp.nn.record_routes() as routes:
                    result = module.main(argv + ["--device", str(dev)] +
                                         DATA_FLAGS[label])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                module.make_train_step = orig
                cap.at(None)
            launched = {k: c.launches - before[k] for k, c in count.items()}
            expected = expected_launches(routes)
            rec = {"data_path": label, "run_s": wall, "step_walls_s": walls,
                   "losses": losses, "launches": launched,
                   "expected_launches": expected, "convs": len(routes),
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                   "card": power}
            emit(rec)
            need(all(math.isfinite(x) for x in losses),
                 f"{label}: finite losses")
            need(launched == expected, f"{label}: launches")
            need(launched["B1"] > 0, f"{label}: B1 launched")
            out["routes"][label] = routes
            out["launches"][label] = launched
            return result, rec

        # (b) train.vae --data, with the npy cache
        parsed = []
        load_off = dsm._MESH_LOADERS[".off"]
        dsm._MESH_LOADERS[".off"] = lambda p: parsed.append(p) or load_off(p)
        cache = os.path.join(tmp, "cache")
        try:
            code, rec = entry("data_vae", tvae, [
                "--data", root, "--cache_dir", cache,
                "--steps", str(DATA_VAE_STEPS),
                "--ckpt_dir", os.path.join(tmp, "ckpt_vae")])
        finally:
            dsm._MESH_LOADERS[".off"] = load_off
        n_train = len(DATA_CLASSES) * DATA_TRAIN
        need(code == 0 and len(rec["step_walls_s"]) == DATA_VAE_STEPS,
             "train.vae --data: its steps")
        need(len(os.listdir(cache)) == n_train and
             sorted(parsed) == sorted(set(parsed)) and
             len(parsed) == n_train,
             "train.vae --data: each mesh parsed once, then the cache")
        emit({"data_vae_cache_files": len(os.listdir(cache)),
              "meshes_parsed": len(parsed)})
        shutil.rmtree(os.path.join(tmp, "ckpt_vae"), ignore_errors=True)
        torch.cuda.empty_cache()

        # (c) train.classification --data
        res, rec = entry("data_cls", tcls, [
            "--data", root, "--steps", str(DATA_CLS_STEPS)])
        need(len(rec["step_walls_s"]) == DATA_CLS_STEPS and
             math.isfinite(res["final_loss"]),
             "train.classification --data: its steps")
        torch.cuda.empty_cache()

        # (d) train.generalize --stream_device, phase 1
        res, rec = entry("data_stream", tgen, [
            "--stream_device", "--steps_vae", str(DATA_STREAM_STEPS),
            "--steps_diff", "0", "--train_shapes", "4", "--val_shapes", "4",
            "--ckpt_dir", os.path.join(tmp, "ckpt_gen")])
        need(res["steps_vae"] == DATA_STREAM_STEPS and res["stream_device"]
             and math.isfinite(res["val_recon_iou"]),
             "train.generalize --stream_device: its steps")
        torch.cuda.empty_cache()

        # (e) PrefetchLoader feeding the VAE step
        enc_caps, dec_caps = mp.serve.capacities(CAP)
        vae = mp.models.VAE(channels=VAE_CH, encoder_capacities=enc_caps,
                            decoder_capacities=dec_caps, device=dev, seed=0)
        state = mp.train.TrainState(vae, mp.train.vae_optimizer(
            vae.parameters(), TRAIN_LR))
        step = mp.train.make_train_step(tvae.build_loss_fn(
            input_capacity=CAP, batch_size=BATCH, resolution=RES,
            kld_weight=TRAIN_KLD, device=dev))
        ds = mp.data.ModelNet40Dataset(root, "train", RES, augment=True)
        rng = np.random.RandomState(0)
        host = []

        def source():
            epochs = itertools.chain.from_iterable(
                mp.data.batch_iterator(ds, BATCH, rng) for _ in range(2))
            for samples in itertools.islice(epochs, DATA_PREFETCH):
                batch = mp.data.collate_pointclouds(
                    [s["coords"] for s in samples], CAP)[:3]
                host.append(batch)
                yield batch
        gen = mp.utils.make_generator(0, dev)
        before = {k: c.launches for k, c in count.items()}
        cap.at("data_prefetch", FUSED)
        walls, losses, equal, all_routes = [], [], [], []
        with mp.data.PrefetchLoader(source(), prefetch=2,
                                    device=dev) as loader:
            for i, batch in enumerate(loader):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with mp.nn.record_routes() as routes:
                    loss, _ = step(state, batch, gen)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                losses.append(float(loss))
                all_routes += routes
                equal.append(all(torch.equal(t.cpu(), torch.as_tensor(h))
                                 for t, h in zip(batch, host[i])))
        cap.at(None)
        launched = {k: c.launches - before[k] for k, c in count.items()}
        emit({"data_path": "data_prefetch", "step_walls_s": walls,
              "losses": losses, "batches_equal_host": equal,
              "launches": launched, "card": power})
        need(len(losses) == DATA_PREFETCH and all(equal) and
             all(map(math.isfinite, losses)),
             "PrefetchLoader: every batch on the card equal to the host's")
        need(launched == expected_launches(all_routes),
             "data_prefetch: launches")
        out["routes"]["data_prefetch"] = all_routes
        out["launches"]["data_prefetch"] = launched
        del vae, state, step
        torch.cuda.empty_cache()

        # (f) the native voxelizer against the plain paths
        need(native.available(), "native: the C++ library builds and loads")
        clouds = [np.asarray(ds[i]["xyz"], np.float32)
                  for i in range(DATA_SHAPES)]
        clouds = [np.concatenate([c] * (-(-DATA_POINTS // len(c))))[
            :DATA_POINTS] for c in clouds]
        coords = np.concatenate([np.floor(c).astype(np.int32)
                                 for c in clouds])
        labels = np.repeat(np.arange(DATA_SHAPES, dtype=np.int32),
                           DATA_POINTS)
        lib = native._load()

        def timed(fn):
            t0 = time.perf_counter()
            r = fn()
            return r, (time.perf_counter() - t0) * 1e3
        plain_ops = {
            "sparse_quantize": lambda: [mp.ops.sparse_quantize_np(c, 1.0)
                                        for c in clouds],
            "quantize_label": lambda: native.quantize_label_plain(
                coords, labels, -100),
            "morton_codes": lambda: mp.ops.morton_encode_np(coords, 1),
            "collate_batch": lambda: _plain_collate(mp, clouds)}
        native_ops = {
            "sparse_quantize": lambda: [native.sparse_quantize(c, 1.0)
                                        for c in clouds],
            "quantize_label": lambda: native.quantize_label(coords, labels,
                                                            -100),
            "morton_codes": lambda: native.morton_codes(coords, 1),
            "collate_batch": lambda: native.collate_batch(
                clouds, 1.0, CAP, mp.ops.INVALID_COORD)}
        nat = {}
        for name in native_ops:
            got, ms = timed(native_ops[name])
            ref, plain_ms = timed(plain_ops[name])
            got = got if isinstance(got, (list, tuple)) else [got]
            ref = ref if isinstance(ref, (list, tuple)) else [ref]
            same = lib is not None and len(got) == len(ref) and all(
                np.array_equal(a, b) for a, b in zip(got, ref))
            nat[name] = {"native_ms": ms, "plain_ms": plain_ms,
                         "equal": bool(same)}
            need(same, f"native.{name} equal to its plain path")
        emit({"native_vs_plain": nat, "clouds": DATA_SHAPES,
              "points_per_cloud": DATA_POINTS, "card": power})

        # (g) procedural_batch on the card against host ProceduralShapes
        pgen = mp.utils.make_generator(0, dev)

        def device_batch():
            return mp.data.procedural_batch(pgen, DATA_SHAPES, DATA_POINTS,
                                            RES, CAP)
        device_batch()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                batch = device_batch()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # each synchronizing call warns ("called a synchronizing CUDA
        # operation"); the mode's notice that it is a prototype is not one
        syncs = [str(w.message)[:120] for w in caught
                 if "synchroniz" in str(w.message).lower() and
                 "prototype" not in str(w.message)]
        dev_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            device_batch()
            torch.cuda.synchronize()
            dev_ms.append((time.perf_counter() - t0) * 1e3)
        per_inst = torch.bincount(batch[0][batch[1]][:, 0].long(),
                                  minlength=DATA_SHAPES).tolist()
        t0 = time.perf_counter()
        hds = mp.data.ProceduralShapes(resolution=RES,
                                       num_samples=DATA_SHAPES,
                                       points_per_shape=DATA_POINTS)
        mp.data.collate_pointclouds([hds[i]["coords"]
                                     for i in range(DATA_SHAPES)], CAP)
        host_s = time.perf_counter() - t0
        emit({"procedural_batch_ms": dev_ms,
              "procedural_batch_ms_median": statistics.median(dev_ms),
              "host_procedural_shapes_s": host_s,
              "voxels_per_instance": per_inst,
              "host_syncs_inside": syncs, "card": power})
        need(not syncs, "procedural_batch: no host synchronization")
        need(min(per_inst) > 0, "procedural_batch: voxels in every shape")

        # (h) the backend canaries on the card
        before = {k: c.launches for k, c in count.items()}
        cap.at("data_diff", FUSED)
        with mp.nn.record_routes() as routes:
            selfcheck = mp.utils.backend_selfcheck(device=dev)
            report = mp.utils.backend_differential_suite(device=dev)
        cap.at(None)
        launched = {k: c.launches - before[k] for k, c in count.items()}
        emit({"backend_selfcheck": selfcheck,
              "backend_differential_suite": report,
              "launches": launched, "card": power})
        need(selfcheck, "backend_selfcheck on the card")
        need(report["_all_ok"] and "conv_fused_bf16" in report,
             "backend_differential_suite on the card")
        need(launched["B1"] == 1, "differential suite: one B1 launch")
        out["launches"]["data_diff"] = launched
        out["routes"]["data_diff"] = []
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    out["ok"] = not failures
    out["failures"] = failures
    emit({"data_phase_s": out["phase_s"], "failures": failures})
    return out


def _plain_collate(mp, clouds):
    """``native.collate_batch``'s plain path: each cloud voxelized by
    numpy, batch-indexed and padded with ``INVALID_COORD``."""
    vox = [mp.ops.sparse_quantize_np(c, 1.0) for c in clouds]
    return mp.ops.pad_to_capacity(mp.ops.batched_coordinates_np(vox), CAP)


# -- the quality and diagnosis entry points --------------------------------
# path: (module of train/, argv): each at its script's full-width run, its
# steps cut (``quality_phase``)
_VQ_WIDE = ["--resolution", "64", "--points", "32768", "--input_capacity",
            "65536", "--vae_channel", "32", "128", "512", "512", "4"]
QUALITY_RUNS = {
    # (40 + 40 steps until the tensor-parallel phase needed the time)
    "quality_e2e": ("e2e_quality", ["--steps_vae", "20", "--steps_diff",
                                    "20"]),
    "quality_vqvae": ("vqvae_quality", _VQ_WIDE + ["--steps", "20"]),
    "quality_vqvae_stream": ("vqvae_quality",
                             _VQ_WIDE + ["--stream", "--steps", "5"]),
    "quality_diag": ("diag_eval_decode", ["--steps_vae", "20"]),
    "quality_occupancy": ("measure_occupancy", []),
}
# each phase's step profiled for the busy share: the one after this step
QUALITY_PROFILE_AFTER = 2


class StepProfile:
    """The device time of one training step inside an entry point's own
    loop, read between two of its ``on_step`` calls: after step
    ``QUALITY_PROFILE_AFTER`` of a phase a ``torch.profiler`` session
    opens (with ``bench_conv.profiled``'s opening markers) and after the
    next step it closes (its closing markers); a session whose records are
    not whole, as ``bench_conv.profiled`` judges, is dropped and the next
    step profiled, up to ``PROFILE_TRIES`` times.  ``busy[phase]`` is the
    profiled step's device seconds, ``profiled[phase]`` its step."""

    def __init__(self):
        self.prof = self.phase = None
        self.busy, self.profiled, self.tries = {}, {}, Counter()
        self.sessions = []  # (phase, markers opened, closed, rows, busy s)

    def _close(self):
        import torch
        from mink_octtree_stablediffusion_tpu_torch import bench_conv as bc
        torch.cuda.synchronize()
        for _ in range(bc.PROFILE_CLOSE):
            self.closing.fill_(1.0)
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        rows, opened, closed = bc.session_rows(self.prof)
        self.prof = None
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        self.sessions.append((self.phase, opened, closed, len(rows), busy))
        return busy if opened and closed == bc.PROFILE_CLOSE else None

    def __call__(self, phase, step):
        import torch
        from torch.profiler import ProfilerActivity, profile
        from mink_octtree_stablediffusion_tpu_torch import bench_conv as bc
        if self.prof is not None:
            busy = self._close()
            if busy is not None and self.phase == phase:
                self.busy[phase], self.profiled[phase] = busy, step
            else:
                self.tries[self.phase] += 1
        if (phase not in self.busy and step >= QUALITY_PROFILE_AFTER and
                self.tries[phase] < bc.PROFILE_TRIES):
            # made before the session: its zero fill is a closing marker
            self.closing = torch.zeros(1, dtype=torch.complex64,
                                       device="cuda")
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            for _ in range(bc.PROFILE_OPEN):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            self.phase = phase

    def close(self):
        if self.prof is not None:
            self._close()


def quality_checks(path, res, walls, losses) -> list:
    """What an entry point's result must show: its script's JSON keys,
    finite values, IoUs (and the diag tables' shares) in [0, 1]; for
    e2e_quality a VAE loss at its last step below step 1's."""
    keys = {"quality_e2e": {"bce", "reconstruction_iou", "generation_iou"},
            "quality_vqvae": {"reconstruction_iou", "bce", "vq_loss",
                              "codebook_perplexity", "active_code_fraction",
                              "generalize"},
            "quality_diag": {"eval_table", "train_table", "eval_iou",
                             "train_iou"},
            "quality_occupancy": {"mean_voxels_by_stride", "input_capacity",
                                  "encoder_capacities",
                                  "decoder_capacities"}}
    keys["quality_vqvae_stream"] = keys["quality_vqvae"]
    bad = []
    if set(res) != keys[path]:
        bad.append(f"{path}: keys {sorted(res)}")
    nums = [v for v in res.values() if isinstance(v, float)]
    shares = [res[k] for k in ("reconstruction_iou", "generation_iou",
                               "eval_iou", "train_iou",
                               "active_code_fraction") if k in res]
    for table in (res[k] for k in ("eval_table", "train_table") if k in res):
        shares += [r[k] for r in table for k in ("recall", "precision")]
        if len(table) != 4:
            bad.append(f"{path}: a table of {len(table)} levels")
    if not all(math.isfinite(v) for v in nums + shares):
        bad.append(f"{path}: a value not finite")
    if not all(0.0 <= v <= 1.0 for v in shares):
        bad.append(f"{path}: an IoU or share outside [0, 1]")
    if path == "quality_e2e" and not losses["vae"][-1] < losses["vae"][0]:
        bad.append(f"{path}: VAE loss of the last step not below step 1's")
    if path.startswith("quality_vqvae") and not (
            1.0 <= res["codebook_perplexity"] <= 512.0):
        bad.append(f"{path}: perplexity outside [1, 512]")
    if path != "quality_occupancy" and not walls:
        bad.append(f"{path}: no training step")
    return bad


def quality_phase(mp, dev, cap, power) -> dict:
    """The four quality and diagnosis entry points through their ``main``
    (``QUALITY_RUNS``), each with the kernels' counts at 0:

    a. ``train.e2e_quality`` at its defaults, its script's "TPU run"
       (resolution 32, batch 4, 4,096 points, 8,192 rows, VAE (16, 32, 64,
       64, 4), UNet (4, 64, 128, 192), 50 DDPM sampling steps), cut to 40
       VAE and 40 diffusion steps;
    b. ``train.vqvae_quality`` at its docstring's overfit run (resolution
       64, 32,768 points, 65,536 rows, VAE (32, 128, 512, 512, 4), 512
       codes) cut to 20 steps, then ``--stream`` at the same widths, 5
       steps (batches made on the card);
    c. ``train.diag_eval_decode`` at its defaults (the same widths), cut
       to 20 VAE steps: the per-level tables in eval and train mode;
    d. ``train.measure_occupancy`` at its defaults (resolution 128, batch
       4, 250,000 points, 16 shells), on the host.

    Each result must hold ``quality_checks``; the launches of each run
    must equal its routes' (``expected_launches``, the eval passes
    included), no conv may take the plain route, and d must launch
    nothing.  ``cap`` keeps the operands of every launch shape (paths
    ``quality_*``) for the kernel checks.  Prints each run's step walls,
    each training phase's busy share (one step profiled inside its loop,
    ``StepProfile``, against the median unprofiled step wall) and the peak
    memory (beside what the earlier paths still held when it started)."""
    import importlib
    import torch
    failures, out = [], {"routes": {}, "launches": {}, "results": {}}
    count = counters(mp)
    t_phase = time.perf_counter()
    for path, (module, argv) in QUALITY_RUNS.items():
        mod = importlib.import_module(
            f"mink_octtree_stablediffusion_tpu_torch.train.{module}")
        for c in count.values():
            c.launches = 0
        walls, losses, prof = {}, {}, StepProfile()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)  # by the earlier paths
        last = [time.perf_counter()]
        t0 = last[0]

        def on_step(phase, step, loss, aux):
            torch.cuda.synchronize()
            walls.setdefault(phase, []).append(time.perf_counter() - last[0])
            losses.setdefault(phase, []).append(float(loss))
            prof(phase, step)
            last[0] = time.perf_counter()
        kw = {} if module == "measure_occupancy" else {"on_step": on_step}
        cap.at(path, FUSED)
        try:
            with mp.nn.record_routes() as routes:
                res = mod.main(argv + ["--device", str(dev)], **kw)
            torch.cuda.synchronize()
        finally:
            cap.at(None)
            prof.close()
        run_s = time.perf_counter() - t0
        launched = {n: c.launches for n, c in count.items()}
        want = expected_launches(routes)
        branches = dict(Counter(r.branch for r in routes))
        busy = {}
        for phase, ws in walls.items():
            unprofiled = [w for i, w in enumerate(ws[1:], 2)
                          if i != prof.profiled.get(phase)]
            if phase in prof.busy and unprofiled:
                busy[phase] = prof.busy[phase] / statistics.median(
                    unprofiled)
        rec = {"quality_path": path, "argv": argv, "result": res,
               "run_s": run_s, "step_walls_s": walls,
               "wall_s_median": {p: statistics.median(ws[1:])
                                 for p, ws in walls.items() if ws[1:]},
               "losses_first_last": {p: [ls[0], ls[-1]]
                                     for p, ls in losses.items()},
               "device_busy_s": prof.busy, "profiled_step": prof.profiled,
               "profile_sessions": prof.sessions,
               "device_busy_share": busy,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
               "memory_held_before_bytes": held,
               "launches": launched, "expected_launches": want,
               "branches": branches, "card": power}
        emit(rec)
        bad = quality_checks(path, res, walls, losses)
        if launched != want:
            bad.append(f"{path}: launches")
        if "plain" in branches:
            bad.append(f"{path}: a plain route on the card")
        if module == "measure_occupancy" and any(launched.values()):
            bad.append(f"{path}: a launch on the host path")
        if module != "measure_occupancy" and not launched["B1"]:
            bad.append(f"{path}: no B1 launch")
        if set(walls) != set(busy):
            bad.append(f"{path}: a training phase without a busy share")
        failures += bad
        out["routes"][path], out["launches"][path] = routes, launched
        out["results"][path] = res
        torch.cuda.empty_cache()
    emit({"quality_phase_s": time.perf_counter() - t_phase,
          "failures": failures})
    out.update(ok=not failures, failures=failures)
    return out


# -- the fused conv's whole domain (float32 compute, 2-D grids, K > 125) --
# train.check_bf16_training's steps an arm here: cut from its --steps
# default of 200 so that the script keeps its time limit (at 200 the phase
# took 102 s and the whole script 1,120 s on the H100; 50 until the
# quality phase needed the time); the curves fall from 0.82 to ~0.22 BCE
# by step 30 in both arms (~0.13 by step 50)
PRECISION_STEPS = 30
# the fused kernels' variants and the brick kernels' float32 ones: (module
# in ops/, wrapper, source, the TPU kernel it replaces), as KERNELS
VARIANTS = {**{f"{k}-{v}": KERNELS[k] for v in ("f32", "2d") for k in FUSED},
            **{f"{k}-f32": KERNELS[k] for k in BRICK}}
BRICK_F32 = tuple(f"{k}-f32" for k in BRICK)
# the float32 arm's steps run again with the brick gate on, each loss
# within BRICK_F32_LOSS_RTOL (relative) of the gate-off arm's
BRICK_F32_STEPS, BRICK_F32_LOSS_RTOL = 3, 1e-5
# the 2-D conv at a real size: 4 instances of a full 256 x 256 grid, 64->64
DOMAIN_2D = dict(batch=4, side=256, cin=64, cout=64)
# the k=7 cube: 2 instances of 3,000 random points in a 32^3 extent, 16->16
DOMAIN_K7 = dict(batch=2, points=3000, extent=32, capacity=8192, cin=16,
                 cout=16)


def check_variant(mp, kernel, path, key, ops, compute, kind):
    """A fused kernel's variant (``kernel`` "B1-f32", "B2-2d", ...) at one
    launch shape ``key`` of ``path``, through ``check_conv_launch`` or
    ``check_dkernel_launch`` at ``compute``."""
    base = kernel.split("-")[0]
    if base == "B3":
        return check_dkernel_launch(mp, path, kind, ops, compute=compute,
                                    kernel=kernel)
    return check_conv_launch(mp, kernel, path, kind, ops,
                             transpose_weight=base == "B2",
                             compute=compute, forward_shape=list(key))


def precision_phase(mp, dev, cap, power) -> dict:
    """`train.check_bf16_training` at its full-width defaults but its
    steps (the same VAE trained from seed 0 on 4 fixed batches of sphere
    shells, ``PRECISION_STEPS`` steps at float32 compute, then at bf16),
    through its ``setup``, ``run_arm`` and ``verdict``.

    - Prints both curves, the final BCEs and their relative difference,
      each arm's step walls and, from one profiled step of each
      (``profile_run``), its device busy share; the script's three checks
      must hold (``BF16 TRAINING OK``).
    - The float32 arm: TF32 off, and B1/B2/B3 launched as its routes call
      for, every launch their float32 split-term variant; each of its
      launch shapes is held against the float32 plain version within
      ``B7_F32_RTOL``·max|ref|
      (``B1-f32``, ``B2-f32``, ``B3-f32``), the bf16 arm's at bf16 (B1, B2,
      B3, 1e-3·max|ref| + 1e-5), each timed beside its bound and its plain
      version, and summed per step.
    - The float32 arm's first ``BRICK_F32_STEPS`` steps again from the same
      weights and batches with the brick gate on (path
      ``precision_fp32_brick``): the level-0 32→32 convs at 64³ × 4 launch
      B5-f32, dF-f32 and B6-f32, each step's loss within
      ``BRICK_F32_LOSS_RTOL`` of the gate-off arm's, and each brick launch
      shape held against its float32 plain version within
      ``B7_F32_RTOL``·max|ref|, timed beside its bound, its plain version
      and cuDNN's float32 call (TF32 off).

    Returns ok, the failures, the kernel records by (kernel, path), the
    f32 variants' launches and their times per float32 step."""
    import torch
    from mink_octtree_stablediffusion_tpu_torch.train import \
        check_bf16_training as cb
    failures, recs, t_phase = [], {}, time.perf_counter()
    env = cb.setup(small=False, device=dev)
    torch.cuda.synchronize()
    emit({"precision_setup_s": time.perf_counter() - t_phase,
          "config": {k: v for k, v in env["cfg"].items()},
          "steps": PRECISION_STEPS,
          "input_voxels": [int(v.sum()) for _, v in env["batches"]],
          "vae_params": sum(p.numel() for p in env["vae"].parameters())})
    count = counters(mp)
    log_every = max(PRECISION_STEPS // 10, 1)
    curves, arms, kinds = {}, {}, {}
    for name, dtype in cb.ARMS:
        path = f"precision_{name}"
        for c in count.values():
            c.launches = 0  # counts from here on are this arm's
        cap.at(path, FUSED)
        t0 = time.perf_counter()
        out = cb.run_arm(env, dtype, PRECISION_STEPS, log_every)
        torch.cuda.synchronize()
        arm_s = time.perf_counter() - t0
        cap.at(None)
        launched = {n: count[n].launches for n in FUSED}
        want = {n: v * PRECISION_STEPS for n, v in
                expected_launches(out["routes"]).items() if n in FUSED}
        branches = dict(Counter(r.branch for r in out["routes"]))
        kinds.update({(r.n_out, r.cin, r.cout, r.k): r.layer
                      for r in out["routes"]})
        walls = out["walls"]
        q = statistics.quantiles(walls[1:], n=4)
        curves[name] = out["curve"]
        print(cb.format_curve(name, out["curve"]), flush=True)
        prof = profile_run(f"one {name} step of check_bf16_training",
                           out["one_more_step"], statistics.median(walls[1:]))
        arms[name] = {"arm_s": arm_s, "wall_s_first": walls[0],
                      "wall_s_median": statistics.median(walls[1:]),
                      "wall_s_quartiles": [q[0], q[2]],
                      "device_busy_share": prof["device_busy_share"],
                      "branches_per_step": branches, "launches": launched,
                      "expected_launches": want, "tf32": out["tf32"],
                      "losses": out["losses"]}
        emit({"precision_arm": name, "card": power, **arms[name]})
        if launched != want:
            failures.append(f"{name} arm launches")
        if out["tf32"]:
            failures.append(f"{name} arm TF32")
        del out
    f32_final, bf16_final, rel, fails = cb.verdict(curves, 0.15)
    print(f"final BCE fp32={f32_final:.4f} bf16={bf16_final:.4f} "
          f"rel_diff={rel:.3f}", flush=True)
    emit({"precision_verdict": "BF16 TRAINING OK" if not fails else fails,
          "final_bce_fp32": f32_final, "final_bce_bf16": bf16_final,
          "first_bce_fp32": curves["fp32"][0][1], "rel_diff": rel,
          "tol": 0.15, "curves": curves})
    failures += fails

    # the float32 arm's first steps again with the brick gate on: its k3 s1
    # convs of <= 128 channels launch B5-f32, dF-f32 and B6-f32
    path = "precision_fp32_brick"
    for c in count.values():
        c.launches = 0
    cap.at(path, KERNELS)
    mp.ops.enable_brick_conv(True)
    try:
        out = cb.run_arm(env, torch.float32, BRICK_F32_STEPS, 1)
        torch.cuda.synchronize()
    finally:
        mp.ops.enable_brick_conv(False)
        cap.at(None)
    launched = {n: count[n].launches for n in KERNELS}
    want = {n: v * BRICK_F32_STEPS for n, v in
            expected_launches(out["routes"]).items()}
    off = arms["fp32"]["losses"][:BRICK_F32_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(out["losses"], off)]
    kinds.update({(r.n_out, r.cin, r.cout, r.k): r.layer
                  for r in out["routes"]})
    brick_arm = {"losses_gate_on": out["losses"], "losses_gate_off": off,
                 "loss_rel_err": rel, "wall_s": out["walls"],
                 "branches_per_step": dict(Counter(
                     r.branch for r in out["routes"])),
                 "launches": launched, "expected_launches": want,
                 "tf32": out["tf32"]}
    emit({"precision_fp32_brick": BRICK_F32_STEPS, "card": power,
          **brick_arm, "tol": BRICK_F32_LOSS_RTOL})
    if launched != want or not all(launched[n] for n in BRICK):
        failures.append("fp32 brick arm launches")
    if not max(rel) <= BRICK_F32_LOSS_RTOL or out["tf32"]:
        failures.append("fp32 brick arm against the gate-off arm")
    del out

    for name, dtype in cb.ARMS:
        path = f"precision_{name}"
        compute = name.replace("fp32", "f32")
        for base in FUSED:
            kernel = f"{base}-f32" if compute == "f32" else base
            got = recs.setdefault((kernel, path), {})
            for key, ops in sorted(cap.case(path, base).items()):
                got[key] = check_variant(mp, kernel, path, key, ops, compute,
                                         kinds.get(key, "?"))
            if set(got) != set(cap.counts.get(path, {}).get(base, {})):
                failures.append(f"{kernel} checked at every launch shape "
                                f"of {path}")
    path = "precision_fp32_brick"
    for base in BRICK:
        got = recs.setdefault((f"{base}-f32", path), {})
        for key, ops in sorted(cap.case(path, base).items()):
            got[key] = check_brick_launch(mp, base, path, key, ops)
        if set(got) != set(cap.counts.get(path, {}).get(base, {})):
            failures.append(f"{base}-f32 checked at every launch shape of "
                            f"{path}")
    for base in FUSED:  # the fused route's float32 launches of that run
        got = recs.setdefault((f"{base}-f32", path), {})
        known = set(recs[(f"{base}-f32", "precision_fp32")])
        for key, ops in sorted(cap.case(path, base).items()):
            if key not in known:
                got[key] = check_variant(mp, f"{base}-f32", path, key, ops,
                                         "f32", kinds.get(key, "?"))
    if not all(r["ok"] for got in recs.values() for r in got.values()):
        failures.append("precision kernel checks")
    per_step = {}
    for base in FUSED:
        kernel = f"{base}-f32"
        per = cap.per_step("precision_fp32", base, PRECISION_STEPS)
        per_step[kernel] = {"launches": sum(per.values()),
                            **totals(per, recs[(kernel, "precision_fp32")])}
        bf = cap.per_step("precision_bf16", base, PRECISION_STEPS)
        per_step[base + " (bf16 arm)"] = {
            "launches": sum(bf.values()),
            **totals(bf, recs[(base, "precision_bf16")])}
    for base in BRICK:  # per float32 gate-on step
        kernel = f"{base}-f32"
        per = cap.per_step("precision_fp32_brick", base, BRICK_F32_STEPS)
        per_step[kernel] = {
            "launches": sum(per.values()),
            **totals(per, recs[(kernel, "precision_fp32_brick")])}
    emit({"precision_step_kernel_account": per_step, "card": power})
    emit({"precision_phase_s": time.perf_counter() - t_phase,
          "failures": failures})
    del env
    torch.cuda.empty_cache()
    return {"ok": not failures, "failures": failures, "recs": recs,
            "launches": {**{f"{b}-f32": arms["fp32"]["launches"][b]
                            for b in FUSED},
                         **{f"{b}-f32": brick_arm["launches"][b]
                            for b in BRICK}},
            "per_step": per_step}


def domain_2d_cases(mp, dev) -> dict:
    """`tests/test_2d.py`'s two cases on the card and on the CPU, bf16
    compute on both (the card's default; the plain versions on the CPU):
    the k3 conv of a full 6x6 grid through the fused route, and the k2 s2
    down / transpose up round trip (its routes fused), each launching B1
    once a conv on the card.  Returns the comparisons; the card tests
    call it too."""
    import numpy as np
    import torch
    rng = np.random.RandomState(0)
    g = np.stack(np.meshgrid(np.arange(6), np.arange(6), indexing="ij"),
                 -1).reshape(-1, 2)
    coords = np.concatenate([np.zeros((len(g), 1), np.int32), g],
                            1).astype(np.int32)
    feats = rng.randn(len(coords), 3).astype(np.float32)
    conv = mp.nn.SparseConv(3, 4, kernel_size=3, ndim=2, device="cpu")
    c2 = np.concatenate([np.zeros((32, 1), np.int32),
                         rng.randint(0, 8, (32, 2))], 1).astype(np.int32)
    cpad, valid = mp.ops.pad_to_capacity(c2, 32)
    f2 = (rng.randn(32, 4) * valid[:, None]).astype(np.float32)
    down = mp.nn.SparseConv(4, 8, kernel_size=2, stride=2, ndim=2,
                            out_capacity=16, device="cpu")
    up = mp.nn.SparseConvTranspose(8, 4, kernel_size=2, stride=2, ndim=2,
                                   device="cpu")
    outs, branches, b1 = {}, {}, mp.ops.fused_conv.fused_sparse_conv
    launched = []  # B1's launches on the card: the full conv, the round trip
    mp.ops.set_default_compute_dtype(torch.bfloat16)
    try:
        for d in ("cpu", dev):
            st = mp.sparse_tensor(torch.as_tensor(coords, device=d),
                                  torch.as_tensor(feats, device=d),
                                  capacity=len(coords), extent=(6, 6))
            before = b1.launches
            full = mp.ops.fused_sparse_conv(st.features, conv.kernel.to(d),
                                            st.grid, st.grid, conv.spec)
            launched.append(b1.launches - before)
            st2 = mp.sparse_tensor(torch.as_tensor(cpad, device=d),
                                   torch.as_tensor(f2, device=d),
                                   capacity=32,
                                   valid=torch.as_tensor(valid, device=d),
                                   extent=(8, 8))
            before = b1.launches
            with mp.nn.record_routes() as routes:
                rt = up.to(d)(down.to(d)(st2), st2.grid)
            launched.append(b1.launches - before)
            branches[str(d)] = [r.branch for r in routes]
            outs[str(d)] = (full.detach().cpu(),
                            rt.features.detach().cpu(), rt.grid.coords.cpu())
    finally:
        mp.ops.set_default_compute_dtype(None)
    out = {}
    for i, (case, want) in enumerate((("k3_full_6x6", 1),
                                      ("down_up_round_trip", 2))):
        got, ref = outs[str(dev)][i], outs["cpu"][i]
        err = (got - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        out[case] = {"max_abs_err": err, "max_abs_ref": ref_max,
                     "tol": 1e-3 * ref_max + 1e-5, "b1_launches":
                     launched[2 + i],
                     "ok": err <= 1e-3 * ref_max + 1e-5 and ref_max > 0
                     and launched[2 + i] == want and launched[i] == 0}
    out["down_up_round_trip"]["ok"] &= bool(
        torch.equal(outs[str(dev)][2], outs["cpu"][2]) and
        branches[str(dev)] == ["fused", "fused"])
    return out


def domain_phase(mp, dev, cap, power) -> dict:
    """The fused conv's domain beyond 3-D bf16 (``fused_conv.
    kernel_domain``), each part with the launch counts set to 0 just before
    it and read just after:

    - 2-D grids: `tests/test_2d.py`'s two cases on the card against the
      CPU (``domain_2d_cases``); then a 2-D k3 conv at a real size
      (``DOMAIN_2D``: 4 full 256 x 256 grids, 64->64, bf16 compute),
      forward and both gradients through ``ops.fused_sparse_conv``: B1, B2
      and B3 each launch once on it, and every 2-D launch shape of the part
      is held against its plain version within 1e-3·max|ref| + 1e-5
      (``B1-2d``, ``B2-2d``, ``B3-2d``), timed beside its bound.
    - K > 125: a k=7 cube (K = 343, ``DOMAIN_K7``) launches B1, B2 and B3
      once per band of offsets (``fused_conv.offset_bands``: 125, 125,
      93); its layer's forward and both gradients equal the CPU's plain
      versions (bf16 compute on both) within 1e-3·max|ref| + 1e-5.

    Returns ok, the failures, the kernel records by (kernel, path), the
    2-D variants' launches and their times over the part."""
    import numpy as np
    import torch
    fc = mp.ops.fused_conv
    failures, recs, t_phase = [], {}, time.perf_counter()
    count = counters(mp)
    for c in count.values():
        c.launches = 0  # counts from here on are the 2-D part's
    cap.at("domain_2d", FUSED)
    cases = domain_2d_cases(mp, dev)
    emit({"domain_test_2d_cases": "card vs cpu", **cases})
    failures += [f"test_2d case {n}" for n, c in cases.items() if not c["ok"]]
    b, side = DOMAIN_2D["batch"], DOMAIN_2D["side"]
    cin, cout = DOMAIN_2D["cin"], DOMAIN_2D["cout"]
    xy = torch.stack(torch.meshgrid(torch.arange(side), torch.arange(side),
                                    indexing="ij"), -1).reshape(-1, 2)
    coords = torch.cat([torch.arange(b).repeat_interleave(side * side)[:, None],
                        xy.repeat(b, 1)], 1).int().to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = coords.shape[0]
    st = mp.sparse_tensor(coords, torch.randn(n, cin, device=dev,
                                              generator=gen),
                          capacity=n, batch_size=b, extent=(side, side))
    spec = mp.ops.KernelSpec(3, 1, ndim=2)
    f = st.features.clone().requires_grad_()
    k = (torch.randn(9, cin, cout, device=dev, generator=gen) /
         math.sqrt(9 * cin)).requires_grad_()
    before = {name: count[name].launches for name in FUSED}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = mp.ops.fused_sparse_conv(f, k, st.grid, st.grid, spec)
    out.backward(torch.randn(n, cout, device=dev, generator=gen))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cap.at(None)
    big = {name: count[name].launches - before[name] for name in FUSED}
    launches = {f"{name}-2d": count[name].launches for name in FUSED}
    emit({"domain_2d_conv": DOMAIN_2D, "rows": n, "wall_s": wall,
          "launches": big, "finite": bool(torch.isfinite(out).all() and
                                          torch.isfinite(f.grad).all() and
                                          torch.isfinite(k.grad).all()),
          "launches_2d_part": launches})
    if big != dict.fromkeys(FUSED, 1):
        failures.append("2-D conv launches")
    del out, f, k, st
    for base in FUSED:
        kernel = f"{base}-2d"
        got = recs.setdefault((kernel, "domain_2d"), {})
        for key, ops in sorted(cap.case("domain_2d", base).items()):
            got[key] = check_variant(mp, kernel, "domain_2d", key, ops,
                                     "bf16", "k3s1 2-D" if key[0] == n
                                     else "test_2d")
        if set(got) != set(cap.counts.get("domain_2d", {}).get(base, {})):
            failures.append(f"{kernel} checked at every launch shape")
    if not all(r["ok"] for got in recs.values() for r in got.values()):
        failures.append("2-D kernel checks")
    per_part = {f"{b_}-2d": totals(
        cap.per_step("domain_2d", b_, 1), recs[(f"{b_}-2d", "domain_2d")])
        for b_ in FUSED}
    emit({"domain_2d_kernel_account": per_part, "card": power})

    # K = 343 in bands of offsets, card vs CPU
    cfg = DOMAIN_K7
    rng = np.random.RandomState(7)
    rows = []
    for i in range(cfg["batch"]):
        c = np.unique(rng.randint(0, cfg["extent"], (cfg["points"], 3)),
                      axis=0)
        rows.append(np.concatenate([np.full((len(c), 1), i, np.int32), c],
                                   1))
    cpad, valid = mp.ops.pad_to_capacity(np.concatenate(rows),
                                         cfg["capacity"])
    feats = (rng.randn(cfg["capacity"], cfg["cin"]) *
             valid[:, None]).astype(np.float32)
    gout = rng.randn(cfg["capacity"], cfg["cout"]).astype(np.float32)
    conv = mp.nn.SparseConv(cfg["cin"], cfg["cout"], kernel_size=7,
                            device="cpu")
    res, k7 = {}, {}
    mp.ops.set_default_compute_dtype(torch.bfloat16)
    try:
        for d in ("cpu", dev):
            c = conv.to(d)
            c.zero_grad()
            x = mp.sparse_tensor(torch.as_tensor(cpad, device=d),
                                 torch.as_tensor(feats, device=d),
                                 capacity=cfg["capacity"],
                                 batch_size=cfg["batch"],
                                 valid=torch.as_tensor(valid, device=d),
                                 extent=(cfg["extent"],) * 3)
            leaf = x.features.clone().requires_grad_()
            x = mp.SparseTensor(grid=x.grid, features=leaf)
            for w in count.values():
                w.launches = 0
            t0 = time.perf_counter()
            with mp.nn.record_routes() as routes:
                y = c(x).features
            y.backward(torch.as_tensor(gout, device=d))
            if d == dev:
                torch.cuda.synchronize()
                k7 = {"wall_s": time.perf_counter() - t0,
                      "branches": [r.branch for r in routes],
                      "launches": {n_: count[n_].launches for n_ in FUSED}}
            res[str(d)] = [t.detach().cpu() for t in (y, leaf.grad,
                                                      c.kernel.grad)]
    finally:
        mp.ops.set_default_compute_dtype(None)
    for name, got, ref in zip(("out", "dF", "dW"), res[str(dev)],
                              res["cpu"]):
        err = (got - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        k7[name] = {"max_abs_err": err, "max_abs_ref": ref_max,
                    "ok": err <= 1e-3 * ref_max + 1e-5 and ref_max > 0}
    emit({"domain_k7_cube": cfg, "k": 343, "card": power, **k7})
    bands = len(fc.offset_bands(343))
    if not (k7["branches"] == ["fused"] and
            k7["launches"] == dict.fromkeys(FUSED, bands) and
            all(k7[n_]["ok"] for n_ in ("out", "dF", "dW"))):
        failures.append("k=7 cube in bands of offsets")
    emit({"domain_phase_s": time.perf_counter() - t_phase,
          "failures": failures})
    torch.cuda.empty_cache()
    return {"ok": not failures, "failures": failures, "recs": recs,
            "launches": launches, "per_part": per_part, "k7": k7}


CHECKED_PATHS = (("generation", ("B1",)), ("canvas", ("B1",)),
                 ("serve", ("B1",)), ("vae_train", FUSED),
                 ("diffusion", KERNELS), ("vae_gate_on", BRICK),
                 ("diffusion_gate_off", ("B1",)), ("vae_gate_off", ("B1",)),
                 ("canvas_vae", FUSED), ("canvas_vae_bf16", FUSED),
                 ("noise_points", KERNELS))


def dp_config() -> dict:
    """The module constants a rank reads: it imports this script afresh,
    so a caller's changes to them reach it only through here."""
    names = ("RES", "CAP", "STEPS", "VAE_CH", "UNET_CH", "GROUP", "MAX_KEEP",
             "VAE_SCALE", "TRAIN_LR", "TRAIN_KLD", "DIFF_FLAGS", "DEVICE",
             "DP_BATCH", "DP_VAE_STEPS", "DP_DIFF_STEPS", "DP_RESNET_STEPS",
             "TP_BATCH", "TP_STEPS", "TP_FLAGS", "TP_CONTROL_FACTOR")
    return {n: globals()[n] for n in names}


def dp_sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_peak(dev):
    """This process's peak device memory since the last reset (None on
    the CPU), and a reset."""
    import torch
    if dev.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return peak


def dp_replicas_equal(module) -> bool:
    """Every rank holds the same parameters and buffers, bit for bit."""
    from mink_octtree_stablediffusion_tpu_torch.multigpu_dp import (
        replica_digests)
    return len(set(replica_digests(module))) == 1


def dp_generate_fn(mp, dev):
    """The generation program at the path's configuration (weights from
    seed 0, as on every rank), a list that collects its decoder's output
    features, one a request, and the hook that fills it."""
    vae, unet = mp.serve.generation_models(
        input_capacity=CAP, batch_size=DP_BATCH, vae_channel=VAE_CH,
        unet_channel=UNET_CH, group=GROUP, max_keep=MAX_KEEP, device=dev,
        seed=0)
    fn = mp.serve.build_generate_fn(
        vae, unet, mp.diffusion.DDIMScheduler.create(), input_capacity=CAP,
        batch_size=DP_BATCH, resolution=RES, vae_scale=VAE_SCALE,
        sample_steps=STEPS, device=dev)
    decoded = []
    hook = vae.decoder.register_forward_hook(
        lambda m, i, o: decoded.append(o[2].features))
    return fn, decoded, hook


def dp_request_input(mp, rank: int):
    """(cpad, valid) of rank ``rank``'s sampling request: `SyntheticShapes`
    2r, 2r+1 (a single process rebuilds it to check the rank's shard)."""
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=64)
    return mp.data.collate_pointclouds(
        [ds[DP_BATCH * rank + j]["coords"] for j in range(DP_BATCH)],
        CAP)[:2]


@contextlib.contextmanager
def dp_sync_off(mp, model):
    """Inside the block ``model``'s BatchNorms do not sync (one process's
    step on the same model)."""
    bns = [m for m in model.modules() if isinstance(m, mp.nn.BatchNorm)]
    groups = [m.process_group for m in bns]
    for m in bns:
        m.process_group = None
    try:
        yield
    finally:
        for m, g in zip(bns, groups):
            m.process_group = g


def dp_emit(rank: int, rec: dict) -> None:
    """Rank 0 prints its records as they come (two ranks' lines would
    interleave); ``dp_phase`` prints every rank's summary."""
    if rank == 0:
        emit({"rank": rank, **rec})


def dp_account(out, routes, launched) -> None:
    """Keep each route's layer name by launch shape (``out["kinds"]``) and
    add a DP run's launches to the path's (``out["launches"]``)."""
    out.setdefault("kinds", {}).update(
        {(r.n_out, r.cin, r.cout, r.k): r.layer for r in routes})
    out.setdefault("launches", Counter()).update(launched)


def dp_step(mp, dev, out, path, i, run) -> dict:
    """One step (``run()`` → (loss, aux)) with its wall time and launches
    against its routes'."""
    count = counters(mp)
    before = {n: c.launches for n, c in count.items()}
    dp_sync(dev)
    t0 = time.perf_counter()
    with mp.nn.record_routes() as routes:
        loss, _ = run()
    dp_sync(dev)
    wall = time.perf_counter() - t0
    launched = {n: c.launches - before[n] for n, c in count.items()}
    dp_account(out, routes, launched)
    return {"dp_path": path, "step": i + 1, "wall_s": wall,
            "loss": float(loss), "finite": bool(math.isfinite(float(loss))),
            "launches": launched,
            "launches_ok": launched == expected_launches(routes)}


def dp_vae(mp, dev, cap, rank, world, out) -> None:
    """(a) `examples/train_vae.py`'s VAE with SyncBN under DP: step 1 with
    the same batch and reparameterisation noise on both ranks against one
    process's step on that batch (rank 0, the sync off) and a bf16
    rounding control beside it (the noise rounded to bf16), as
    ``gate_compare``: the DP gradients' loss and relative RMS at the
    median and worst tensor must be within the control's; then
    ``DP_VAE_STEPS`` steps on distinct per-rank batches, each rank's own
    noise (``split_device_rngs``), the replicas bit for bit equal after
    every step."""
    import torch
    import torch.distributed as dist
    from mink_octtree_stablediffusion_tpu_torch.train import vae as tv
    enc, dec = mp.serve.capacities(CAP)
    vae = mp.models.VAE(channels=VAE_CH, encoder_capacities=enc,
                        decoder_capacities=dec,
                        process_group=dist.group.WORLD, device=dev, seed=0)
    mp.train.broadcast_module(vae)
    state = mp.train.TrainState(vae, mp.train.vae_optimizer(
        vae.parameters(), TRAIN_LR))
    loss_fn = tv.build_loss_fn(input_capacity=CAP, batch_size=DP_BATCH,
                               resolution=RES, kld_weight=TRAIN_KLD,
                               device=dev)
    step = mp.train.make_dp_train_step(loss_fn)
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=256)

    def batch(i, r):  # rank r's shapes of global batch i
        return mp.data.collate_pointclouds(
            [ds[(i * world + r) * DP_BATCH + j]["coords"]
             for j in range(DP_BATCH)], CAP, 200_000)[:3]

    same = batch(0, 0)
    eps = torch.randn((enc[2], VAE_CH[4]), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    if rank == 0:
        stats = {n: b.clone() for n, b in vae.named_buffers()}
        ref = {}
        vae.train()
        with dp_sync_off(mp, vae):
            for name, e in (("single", eps), ("control",
                                              eps.bfloat16().float())):
                vae.zero_grad(set_to_none=True)
                loss, _ = loss_fn(vae, same, eps=e)
                loss.backward()
                ref[name] = (loss.item(), grads_of(vae))
                with torch.no_grad():
                    for n, b in vae.named_buffers():
                        b.copy_(stats[n])
        vae.zero_grad(set_to_none=True)
    rec = dp_step(mp, dev, out, "dp_vae_same_batch", -1,
                  lambda: step(state, same, eps=eps))
    rec["replicas_equal"] = dp_replicas_equal(vae)
    if rank == 0:
        d = against(rec["loss"], grads_of(vae), *ref["single"])
        c = against(*ref["control"], *ref["single"])
        rec.update({**d, **{"control_" + k: v for k, v in c.items()},
                    "bit_equal": d["loss_rel_err"] == 0 and
                    d["grad_rel_rms_max"] == 0,
                    "within_control": all(d[k] <= c[k] for k in (
                        "loss_rel_err", "grad_rel_rms_median",
                        "grad_rel_rms_max"))})
        del ref
    dp_emit(rank, rec)
    out["vae_same_batch"] = rec
    gen = mp.train.split_device_rngs(0, world, dev)[rank]
    steps = []
    for i in range(DP_VAE_STEPS):
        cap.at("dp_vae", FUSED if i == 0 else ())
        rec = dp_step(mp, dev, out, "dp_vae", i, lambda: step(
            state, batch(i + 1, rank), generator=gen))
        cap.at(None)
        rec["comm"] = dict(step.comm)
        rec["replicas_equal"] = dp_replicas_equal(vae)
        dp_emit(rank, rec)
        steps.append(rec)
    out["vae_steps"] = steps
    out["vae_peak_bytes"] = dp_peak(dev)


def dp_diffusion(mp, dev, cap, rank, world, out) -> None:
    """(b) `examples/train_diffusion.py`'s defaults under DP (the frozen
    VAE, the UNet (4, 320, 640, 960), the brick gate on): ``DP_DIFF_STEPS``
    steps on distinct per-rank batches, each rank's own timestep and
    noise draws; finite, the launches those of the routes, the replicas
    bit for bit equal after every step."""
    from mink_octtree_stablediffusion_tpu_torch.train import diffusion as td
    cfg = td.parse_args(DIFF_FLAGS + ["--batch_size", str(DP_BATCH)])
    run = td.setup(cfg, dev)
    mp.train.broadcast_module(run.model)
    step = mp.train.make_dp_train_step(run.loss_fn)
    ds = mp.data.SyntheticShapes(resolution=cfg.resolution, num_samples=256)
    gen = mp.train.split_device_rngs(1, world, dev)[rank]
    steps = []
    mp.ops.enable_brick_conv(True)
    try:
        for i in range(DP_DIFF_STEPS):
            batch = mp.data.collate_pointclouds(
                [ds[(i * world + rank) * DP_BATCH + j]["coords"]
                 for j in range(DP_BATCH)], cfg.input_capacity,
                cfg.max_batch_len)[:2]
            cap.at("dp_diffusion", KERNELS if i == 0 else ())
            rec = dp_step(mp, dev, out, "dp_diffusion", i, lambda: step(
                run.state, batch, generator=gen))
            cap.at(None)
            rec["comm"] = dict(step.comm)
            rec["replicas_equal"] = dp_replicas_equal(run.model)
            dp_emit(rank, rec)
            steps.append(rec)
    finally:
        mp.ops.enable_brick_conv(False)
    out["diffusion_steps"] = steps
    out["diffusion_params"] = sum(p.numel() for p in run.model.parameters())
    out["diffusion_peak_bytes"] = dp_peak(dev)


def dp_sampling(mp, dev, cap, rank, world, out) -> None:
    """(c) DP sampling at the generation configuration: each rank serves
    one request (``DP_BATCH`` shapes, DDIM cut to ``STEPS``, the
    ``MAX_KEEP`` clamp) from its own generator; its decoded features must
    be finite with > 0 voxels an instance, and every fused-route conv must
    launch B1; rank 0 gathers the shards (coordinates, valid mask and the
    decoded features) through the host, and ``dp_phase`` holds each
    against one process's request with that rank's generator."""
    import torch
    fn, decoded, hook = dp_generate_fn(mp, dev)
    cpad, valid = dp_request_input(mp, rank)
    gen = mp.train.split_device_rngs(2, world, dev)[rank]
    b1 = counters(mp)["B1"]
    before = b1.launches
    cap.at("dp_sampling", ("B1",))
    dp_sync(dev)
    t0 = time.perf_counter()
    with mp.nn.record_routes() as routes:
        coords, v = fn(cpad, valid, generator=gen)
    dp_sync(dev)
    wall = time.perf_counter() - t0
    cap.at(None)
    hook.remove()
    dp_account(out, routes, {"B1": b1.launches - before})
    feats = decoded.pop()
    per_inst = torch.bincount(coords[v][:, 0].long(),
                              minlength=DP_BATCH).tolist()
    fused = sum(r.branch == "fused" for r in routes)
    rec = {"dp_path": "dp_sampling", "wall_s": wall,
           "voxels_per_instance": per_inst,
           "finite": bool(torch.isfinite(feats).all().item()),
           "b1_launches": b1.launches - before, "fused_route_convs": fused,
           "launches_ok": b1.launches - before == fused}
    dp_emit(rank, rec)
    gathered = [mp.parallel.gather_to_host(t) for t in (
        coords, v.to(torch.uint8), feats.float())]
    if rank == 0:
        out["sampling_shards"] = [tuple(g[r] for g in gathered)
                                  for r in range(world)]
    out["sampling"] = rec
    out["sampling_peak_bytes"] = dp_peak(dev)


def dp_resnet(mp, dev, cap, rank, world, out) -> None:
    """(d) ``multigpu_dp``'s entry (``multigpu_dp.train``, the rank's body)
    at the example's widths (ResNet14, stem 64, planes 64–512, SyncBN) for
    ``DP_RESNET_STEPS`` steps, 2 `SyntheticShapes` a rank at ``RES`` with
    ``CAP`` input rows: finite, and the replicas bit for bit equal (the
    entry checks it and raises otherwise)."""
    from mink_octtree_stablediffusion_tpu_torch import multigpu_dp
    args = multigpu_dp.parse_args([
        "--backend", "gloo", "--steps", str(DP_RESNET_STEPS),
        "--batch_per_device", str(DP_BATCH), "--resolution", str(RES),
        "--capacity", str(CAP), "--ckpt_dir", ""])
    count = counters(mp)
    before = {n: c.launches for n, c in count.items()}
    cap.at("dp_resnet", FUSED)
    with mp.nn.record_routes() as routes:
        got = multigpu_dp.train(args, device=dev)
    cap.at(None)
    launched = {n: c.launches - before[n] for n, c in count.items()}
    dp_account(out, routes, launched)
    rec = {"dp_path": "dp_resnet", "wall_s": got["wall_s"],
           "loss": got["loss"], "comm": got["comm"],
           "finite": bool(all(math.isfinite(x) for x in got["loss"])),
           "replica_digest": got["digest"], "launches": launched,
           "launches_ok": launched == expected_launches(routes)}
    dp_emit(rank, rec)
    out["resnet"] = rec
    out["resnet_peak_bytes"] = dp_peak(dev)


def dp_rank(rank: int, world: int, port: int, tmp: str, cfg: dict) -> None:
    """One rank of the data-parallel phase (a spawned process): joins the
    gloo group with the other rank on the same card, runs (a)-(d) under
    its own ``LaunchCapture``, and saves its records (rank 0 also the
    operands of every launch shape not in ``cfg["known"]``)."""
    import datetime
    import torch
    import torch.distributed as dist
    globals().update({k: v for k, v in cfg.items() if k != "known"})
    sys.path.insert(0, str(HERE))
    import mink_octtree_stablediffusion_tpu_torch as mp
    dev = mp.parallel.rank_device(DEVICE, rank, world)
    mp.parallel.initialize_distributed(
        f"127.0.0.1:{port}", world, rank, backend="gloo",
        timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    out = {"rank": rank}
    try:
        cap = LaunchCapture(mp)
        if rank:  # only rank 0's operands are checked: keep none here
            cap.at = lambda path, on=(): LaunchCapture.at(cap, path)
        with cap:
            for path in (dp_vae, dp_diffusion, dp_sampling, dp_resnet):
                path(mp, dev, cap, rank, world, out)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        out["counts"] = cap.counts
        if rank == 0:
            known = cfg["known"]
            out["cases"] = {
                path: {k: {key: tuple(o.cpu() if torch.is_tensor(o) else o
                                      for o in ops)
                           for key, ops in got.items()
                           if key not in known.get(k, ())}
                       for k, got in kernels.items()}
                for path, kernels in cap.cases.items()}
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_phase(mp, dev, cap, power) -> dict:
    """The data-parallel paths on one card: ``DP_RANKS`` spawned ranks
    (``dp_rank``) in a gloo group, each on the card, run (a) the SyncBN
    VAE (``dp_vae``), (b) diffusion training (``dp_diffusion``), (c)
    sampling (``dp_sampling``) and (d) ``multigpu_dp`` (``dp_resnet``).
    No fallback: a rank that fails, a group that does not form, or a gloo
    without CUDA collectives raises here.  Then, in this one process, each
    rank's sampling shard must equal the request made with that rank's
    generator, and the shards must differ.  Returns the verdict, rank 0's
    launch counts and the operands of its launch shapes not seen on
    earlier paths (``cap``), for the kernel checks."""
    import tempfile
    import torch
    failures = []

    def need(cond, what):
        if not cond:
            failures.append(what)
    cfg = dp_config()
    cfg["known"] = {k: {key for path, kernels in CHECKED_PATHS
                        if k in kernels for key in cap.case(path, k)}
                    for k in KERNELS}

    def move_cases(to):  # the earlier paths' kept operands
        for per in cap.cases.values():
            for got in per.values():
                for key, ops in got.items():
                    got[key] = tuple(o.to(to) if torch.is_tensor(o) else o
                                     for o in ops)
    # the card's memory goes to the two ranks: this process keeps none
    held = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    move_cases("cpu")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            torch.multiprocessing.start_processes(
                dp_rank, args=(DP_RANKS, mp.parallel.free_port(), tmp, cfg),
                nprocs=DP_RANKS, join=True, start_method="spawn")
            ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                     for r in range(DP_RANKS)]
    finally:
        move_cases(dev)
    ranks_wall = time.perf_counter() - t0
    for r, rec in enumerate(ranks):
        same = rec["vae_same_batch"]
        need(same["finite"] and same["launches_ok"] and
             same["replicas_equal"], f"rank {r}: the same-batch VAE step")
        if r == 0:
            need(same["within_control"] or same["bit_equal"],
                 "the same-batch DP VAE step vs one process's")
        for key in ("vae_steps", "diffusion_steps"):
            for s in rec[key]:
                need(s["finite"] and s["launches_ok"] and
                     s["replicas_equal"],
                     f"rank {r}: {s['dp_path']} step {s['step']}")
        smp = rec["sampling"]
        need(smp["finite"] and min(smp["voxels_per_instance"]) > 0 and
             smp["launches_ok"], f"rank {r}: the DP sampling request")
        need(rec["resnet"]["finite"] and rec["resnet"]["launches_ok"],
             f"rank {r}: multigpu_dp")
    need(len({rec["resnet"]["replica_digest"] for rec in ranks}) == 1,
         "multigpu_dp's replicas")
    # each shard against the request of one process with the rank's draws
    shards = ranks[0]["sampling_shards"]
    fn, decoded, hook = dp_generate_fn(mp, dev)
    single = []
    for r in range(DP_RANKS):
        cpad, valid = dp_request_input(mp, r)
        coords, v = fn(cpad, valid, generator=mp.train.split_device_rngs(
            2, DP_RANKS, dev)[r])
        feats = decoded.pop().float().cpu()
        c, vv, f = shards[r]
        single.append({"rank": r,
                       "coords_equal": torch.equal(coords.cpu(), c),
                       "valid_equal": torch.equal(v.cpu().to(torch.uint8),
                                                  vv),
                       "features_max_abs_diff": float(
                           (feats - f).abs().max()),
                       "features_equal": torch.equal(feats, f)})
    hook.remove()
    del fn, hook
    torch.cuda.empty_cache()
    differ = not (torch.equal(shards[0][0], shards[1][0]) and
                  torch.equal(shards[0][2], shards[1][2]))
    need(differ, "the DP sampling shards differ")
    need(all(s["coords_equal"] and s["valid_equal"] and s["features_equal"]
             for s in single), "each DP shard equals one process's request")
    launches = {n: ranks[0]["launches"][n] for n in KERNELS}
    rec = {"dp_phase": "gloo, 2 ranks on one card", "card": power,
           "ranks_wall_s": ranks_wall, "parent_bytes_moved_off": held,
           "single_process_requests": single,
           "shards_differ": differ, "rank0_launches": launches,
           "per_rank": [{
               "rank": r,
               "vae_step_wall_s": [s["wall_s"] for s in rec["vae_steps"]],
               "vae_allreduce_s": [s["comm"]["seconds"]
                                   for s in rec["vae_steps"]],
               "vae_allreduce_bytes": rec["vae_steps"][0]["comm"]["bytes"],
               "diffusion_step_wall_s": [s["wall_s"]
                                         for s in rec["diffusion_steps"]],
               "diffusion_allreduce_s": [s["comm"]["seconds"]
                                         for s in rec["diffusion_steps"]],
               "diffusion_allreduce_bytes":
                   rec["diffusion_steps"][0]["comm"]["bytes"],
               "diffusion_params": rec["diffusion_params"],
               "sampling_wall_s": rec["sampling"]["wall_s"],
               "resnet_step_wall_s": rec["resnet"]["wall_s"],
               "resnet_allreduce_s": [c["seconds"]
                                      for c in rec["resnet"]["comm"]],
               "resnet_allreduce_bytes": rec["resnet"]["comm"][0]["bytes"],
               "peak_bytes": {p: rec[f"{p}_peak_bytes"] for p in (
                   "vae", "diffusion", "sampling", "resnet")}}
               for r, rec in enumerate(ranks)],
           "same_batch_vae_step": {
               k: v for k, v in ranks[0]["vae_same_batch"].items()
               if k not in ("launches", "dp_path", "step")},
           "failures": failures, "ok": not failures}
    emit(rec)
    return {"ok": not failures, "failures": failures,
            "counts": ranks[0]["counts"], "cases": ranks[0]["cases"],
            "launches": launches, "kinds": ranks[0]["kinds"]}


def tp_digest(module, sharded: bool) -> str:
    """SHA-1 of the bytes of ``module``'s replicated parameters, or with
    ``sharded`` of every parameter (slices included) and buffer."""
    import hashlib
    import torch
    h = hashlib.sha1()
    ts = [p for p in module.parameters()
          if sharded or not hasattr(p, "model_shard")]
    if sharded:
        ts += list(module.buffers())
    for t in ts:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy())
    return h.hexdigest()


def tp_replicas(module, mesh) -> dict:
    """Across the model axis the replicated parameters, across the data
    axis every parameter and buffer (the slices too), equal bit for bit."""
    import torch.distributed as dist
    out = {}
    for axis, sharded in (("model", False), ("data", True)):
        every = [None] * mesh[axis].size()
        dist.all_gather_object(every, tp_digest(module, sharded),
                               group=mesh.get_group(axis))
        out[axis] = len(set(every)) == 1
    return out


def tp_model_comm(mp) -> dict:
    """The model-axis collectives since the last ``reset_comm``, by kind."""
    return {k: dict(v) for k, v in mp.parallel.tp.COMM.items()}


def tp_steps(mp, dev, cap, rank, mesh, out) -> None:
    """One rank's tensor-parallel diffusion training: `examples/
    train_diffusion.py`'s defaults (``DIFF_FLAGS``, ``TP_FLAGS``: the frozen
    VAE left whole, the UNet (4, 320, 640, 960), group 32, the brick gate
    on), the UNet's conv and dense kernels sharded on Cout over the model
    axis, the gradients averaged over the data axis.  (a) Both data rows
    take the same batch and draws; rank 0 holds the loss and the gathered
    (clipped) gradients against one process's step on that batch, within
    ``TP_CONTROL_FACTOR`` times the larger of two rounding controls (the
    noise rounded to bf16; moved by 2^-20), as ``dp_vae``.  (b)
    ``TP_STEPS`` steps on a batch of its own a data row, each row's own
    draws: finite, the launches those of the routes, the replicas equal
    bit for bit on each axis, every slice of its local shape."""
    import torch
    from mink_octtree_stablediffusion_tpu_torch.train import diffusion as td
    from mink_octtree_stablediffusion_tpu_torch.train.optim import (
        clip_by_global_norm_)
    cfg = td.parse_args(DIFF_FLAGS + TP_FLAGS +
                        ["--batch_size", str(TP_BATCH)])
    run = td.setup(cfg, dev)  # seed 0 on every rank: the same weights
    model = run.model
    run.state = run.step_fn = None  # their optimizer holds the whole weights
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    row = mesh.get_local_rank("data")
    ds = mp.data.SyntheticShapes(resolution=cfg.resolution, num_samples=256)

    def batch(i, r):  # data row r's shapes of global batch i
        return mp.data.collate_pointclouds(
            [ds[(i * 2 + r) * TP_BATCH + j]["coords"]
             for j in range(TP_BATCH)], cfg.input_capacity,
            cfg.max_batch_len)[:2]

    same = batch(0, 0)
    g = torch.Generator(device=dev).manual_seed(3)
    t = torch.randint(0, cfg.ddpm_num_steps, (TP_BATCH,), generator=g,
                      device=dev, dtype=torch.int32)
    noise = torch.randn((mp.serve.capacities(cfg.input_capacity)[0][2],
                         cfg.unet_channel[0]), generator=g, device=dev)
    mp.ops.enable_brick_conv(True)
    try:
        single, controls = None, {}
        if rank == 0:  # one process's step on the same batch, and controls
            model.train()
            for name, n in (("single", noise),
                            ("control", noise.bfloat16().float()),
                            ("control_f32", noise * (1.0 + 2.0 ** -20))):
                model.zero_grad(set_to_none=True)
                loss, _ = run.loss_fn(model, same, timesteps=t, noise=n)
                loss.backward()
                grads = grads_of(model)
                clip_by_global_norm_(list(grads.values()), 0.5)
                # on the host: four ranks share the card
                got = (loss.item(), {n: g.cpu() for n, g in grads.items()})
                del grads
                if single is None:
                    single = got
                else:
                    controls[name] = against(*got, *single)
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
        dp_sync(dev)
        out["reference_peak_bytes"] = dp_peak(dev)
        mp.parallel.shard_model_params(run.unet, mesh)
        local = {n: tuple(p.shape) for n, p in model.named_parameters()}
        sharded = {n for n, p in model.named_parameters()
                   if hasattr(p, "model_shard")}
        out["params"] = {"full": sum(math.prod(s) for s in full.values()),
                         "local": sum(math.prod(s) for s in local.values()),
                         "sharded_tensors": len(sharded)}
        n_model = mesh["model"].size()

        def shape_ok(n):  # a slice: 1/n_model of the one sharded axis
            if n not in sharded:
                return local[n] == full[n]
            axes = [i for i, (a, b) in enumerate(zip(local[n], full[n]))
                    if a != b]
            return (len(axes) == 1 and
                    n_model * local[n][axes[0]] == full[n][axes[0]])
        out["local_shapes_ok"] = bool(sharded) and all(map(shape_ok, full))
        state = mp.train.TrainState(model, mp.train.diffusion_optimizer(
            model.parameters(), cfg.lr, cfg.warmup, cfg.total_steps))
        step = mp.train.make_dp_train_step(run.loss_fn,
                                           mesh.get_group("data"))
        mp.parallel.tp.reset_comm()
        cap.at("tp_same_batch", KERNELS)
        rec = dp_step(mp, dev, out, "tp_same_batch", -1,
                      lambda: step(state, same, timesteps=t, noise=noise))
        cap.at(None)
        rec["comm"] = dict(step.comm)
        rec["model_comm"] = tp_model_comm(mp)
        grads = mp.parallel.gather_model_params(model, mesh, grads=True,
                                                device="cpu")
        rec["replicas"] = tp_replicas(model, mesh)
        if rank == 0:
            d = against(rec["loss"], grads, *single)
            keys = ("loss_rel_err", "grad_rel_rms_median", "grad_rel_rms_max")
            rec.update({**d, **{f"{name}_{k}": v
                                for name, got in controls.items()
                                for k, v in got.items()},
                        "within_controls": all(
                            d[k] <= max(c[k] for c in controls.values())
                            for k in keys),
                        "within_bound": all(
                            d[k] <= TP_CONTROL_FACTOR *
                            max(c[k] for c in controls.values())
                            for k in keys)})
        del single, grads
        dp_emit(rank, rec)
        out["same_batch"] = rec
        gen = mp.train.split_device_rngs(1, 2, dev)[row]
        steps = []
        for i in range(TP_STEPS):
            mp.parallel.tp.reset_comm()
            rec = dp_step(mp, dev, out, "tp_diffusion", i, lambda: step(
                state, batch(i + 1, row), generator=gen))
            rec["comm"] = dict(step.comm)
            rec["model_comm"] = tp_model_comm(mp)
            rec["replicas"] = tp_replicas(model, mesh)
            rec["local_shapes_ok"] = all(
                tuple(p.shape) == local[n]
                for n, p in model.named_parameters())
            dp_emit(rank, rec)
            steps.append(rec)
        out["steps"] = steps
    finally:
        mp.ops.enable_brick_conv(False)
    out["peak_bytes"] = dp_peak(dev)


def tp_rank(rank: int, world: int, port: int, tmp: str, cfg: dict) -> None:
    """One rank of the tensor-parallel phase (a spawned process): joins the
    gloo group with the other three ranks on the same card, forms the 2 x 2
    mesh, runs ``tp_steps`` under its own ``LaunchCapture`` and saves its
    records (rank 0 also the operands of every launch shape not in
    ``cfg["known"]``)."""
    import datetime
    import torch
    import torch.distributed as dist
    globals().update({k: v for k, v in cfg.items() if k != "known"})
    sys.path.insert(0, str(HERE))
    import mink_octtree_stablediffusion_tpu_torch as mp
    dev = mp.parallel.rank_device(DEVICE, rank, world)
    mp.parallel.initialize_distributed(
        f"127.0.0.1:{port}", world, rank, backend="gloo",
        timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    out = {"rank": rank}
    try:
        t0 = time.perf_counter()
        mesh = mp.parallel.dp_tp_mesh(2, world // 2, dev.type)
        out["mesh_s"] = time.perf_counter() - t0
        out["groups"] = {a: dist.get_process_group_ranks(mesh.get_group(a))
                         for a in ("data", "model")}
        cap = LaunchCapture(mp)
        if rank:  # only rank 0's operands are checked: keep none here
            cap.at = lambda path, on=(): LaunchCapture.at(cap, path)
        with cap:
            tp_steps(mp, dev, cap, rank, mesh, out)
        out["counts"] = cap.counts
        if rank == 0:
            known = cfg["known"]
            out["cases"] = {
                path: {k: {key: tuple(o.cpu() if torch.is_tensor(o) else o
                                      for o in ops)
                           for key, ops in got.items()
                           if key not in known.get(k, ())}
                       for k, got in kernels.items()}
                for path, kernels in cap.cases.items()}
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def tp_phase(mp, dev, cap, power, known) -> dict:
    """Tensor parallelism on one card: ``TP_RANKS`` spawned ranks
    (``tp_rank``) in one gloo group, a 2 x 2 ``(data, model)`` mesh, run
    ``tp_steps``.  The kernels are built before (``main``), so the ranks
    only load them.  No fallback: a rank that fails, a mesh that does not
    form, or a collective that gloo refuses raises here.  Prints the step
    walls, each rank's data-axis and model-axis collective bytes and host
    seconds, its peak memory and the sharded and full parameter counts.
    Returns the verdict, rank 0's launch counts and the operands of its
    launch shapes not seen on the paths of ``known`` (kernel → launch
    shapes), for the kernel checks."""
    import gc
    import tempfile
    import torch
    failures = []

    def need(cond, what):
        if not cond:
            failures.append(what)
    cfg = dp_config()
    cfg["known"] = known

    def move_cases(to):  # the earlier paths' kept operands
        for per in cap.cases.values():
            for got in per.values():
                for key, ops in got.items():
                    got[key] = tuple(o.to(to) if torch.is_tensor(o) else o
                                     for o in ops)
    held = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    move_cases("cpu")
    gc.collect()  # what earlier phases left in reference cycles
    torch.cuda.empty_cache()
    kept = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    emit({"tp_phase_parent_bytes": held, "kept": kept})
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            torch.multiprocessing.start_processes(
                tp_rank, args=(TP_RANKS, mp.parallel.free_port(), tmp, cfg),
                nprocs=TP_RANKS, join=True, start_method="spawn")
            ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                     for r in range(TP_RANKS)]
    finally:
        move_cases(dev)
    ranks_wall = time.perf_counter() - t0
    for r, rec in enumerate(ranks):
        need(rec["groups"] == {"data": [r % 2, r % 2 + 2],
                               "model": [r - r % 2, r - r % 2 + 1]},
             f"rank {r}: the mesh's groups")
        need(rec["local_shapes_ok"], f"rank {r}: the local Cout/2 shapes")
        same = rec["same_batch"]
        need(same["finite"] and same["launches_ok"] and
             all(same["replicas"].values()),
             f"rank {r}: the same-batch tp step")
        if r == 0:
            need(same["within_bound"],
                 "the same-batch dp x tp step vs one process's")
        for s in rec["steps"]:
            need(s["finite"] and s["launches_ok"] and s["local_shapes_ok"]
                 and all(s["replicas"].values()),
                 f"rank {r}: tp step {s['step']}")
    launches = {n: ranks[0]["launches"][n] for n in KERNELS}
    need(all(launches[n] for n in KERNELS),
         "every kernel launched on the tp path")

    def comm(rec):
        return {"data_allreduce_s": rec["comm"]["seconds"],
                "data_allreduce_bytes": rec["comm"]["bytes"],
                "model_axis": rec["model_comm"]}
    rec = {"tp_phase": "gloo, 4 ranks on one card, 2 x 2 (data, model)",
           "card": power, "ranks_wall_s": ranks_wall,
           "parent_bytes_moved_off": held - kept, "parent_bytes_kept": kept,
           "rank0_launches": launches,
           "params": ranks[0]["params"],
           "per_rank": [{
               "rank": r, "mesh_s": x["mesh_s"],
               "same_batch_wall_s": x["same_batch"]["wall_s"],
               "step_wall_s": [s["wall_s"] for s in x["steps"]],
               "same_batch_comm": comm(x["same_batch"]),
               "step_comm": [comm(s) for s in x["steps"]],
               "loss": [x["same_batch"]["loss"]] +
                       [s["loss"] for s in x["steps"]],
               "reference_peak_bytes": x["reference_peak_bytes"],
               "peak_bytes": x["peak_bytes"]}
               for r, x in enumerate(ranks)],
           "same_batch_vs_one_process": {
               k: v for k, v in ranks[0]["same_batch"].items()
               if k not in ("launches", "dp_path", "step", "model_comm",
                            "comm")},
           "failures": failures, "ok": not failures}
    emit(rec)
    return {"ok": not failures, "failures": failures,
            "counts": ranks[0]["counts"], "cases": ranks[0]["cases"],
            "launches": launches, "kinds": ranks[0]["kinds"]}


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
    fallbacks = count_fallbacks(mp)  # before any LaunchCapture wraps it

    def need(cond, what: str) -> None:
        if not cond:
            failed.append(what)

    t_main = time.perf_counter()

    def mark(done: str) -> None:  # the script's seconds so far
        emit({"phase_done": done,
              "elapsed_s": time.perf_counter() - t_main})

    # -- build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = mp.utils.cuda_build.build()
    emit({"build_s": time.perf_counter() - t0,
          "ptxas": {src: [ln.strip() for ln in log.splitlines()
                          if "Used" in ln or "spill" in ln]
                    for src, log in logs.items()}})

    mark("before path 1")
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
        batch_size=BATCH, resolution=RES, vae_scale=VAE_SCALE,
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

    mark("before path 1b")
    # -- path 1b: conditioned, template-free generation on the canvas ----
    try:
        with cap:
            canv = canvas_phase(mp, dev, cap, cpad, valid,
                                args.max_keep or None, power)
    except Exception:
        traceback.print_exc()
        canv = {"ok": False, "failures": ["canvas phase raised"],
                "routes": [], "all_routes": [], "launches": {"B1": 0}}
    need(canv["ok"], "canvas path: " + ", ".join(canv["failures"]))
    hist_canvas = histogram(canv["routes"], lambda r: r.branch == "fused")
    emit_histogram("canvas_fused_launch_shapes_per_request", hist_canvas)
    emit_histogram("canvas_dense_route_shapes_per_request", histogram(
        canv["routes"], lambda r: r.branch == "dense"))
    torch.cuda.empty_cache()

    mark("before path 1c")
    # -- path 1c: the serving artifact, and the generation entry point ----
    try:
        with cap:
            serve = serve_phase(mp, dev, cap, cpad, valid,
                                args.max_keep or None, power)
    except Exception:
        traceback.print_exc()
        serve = {"ok": False, "failures": ["serve phase raised"],
                 "launches": {"B1": 0}}
    need(serve["ok"], "serve path: " + ", ".join(serve["failures"]))
    torch.cuda.empty_cache()
    try:
        need(generate_cli_phase(mp, dev)["ok"], "generate entry point")
    except Exception:
        traceback.print_exc()
        need(False, "generate entry point")
    torch.cuda.empty_cache()

    mark("before path 2")
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

    mark("before path 3")
    # -- path 3: 10 steps of full-width diffusion training --------------
    with cap:
        diff = diffusion_phase(mp, dev, cap)
    diff_cmp, diff_off, diff_on = diff["compare"]
    need(diff["ok"], "diffusion training path")
    need(diff_cmp["ok"], "diffusion gate comparison")
    need(all(c["ok"] for c in diff["compare_f32"]),
         "diffusion gate comparison at float32")
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

    mark("before path 3b")
    # -- path 3b: training of the canvas and conditioned models ---------
    try:
        with cap:
            ctrain = canvas_train_phase(mp, dev, cap, power)
    except Exception:
        traceback.print_exc()
        ctrain = {"ok": False, "failures": ["canvas train phase raised"],
                  "routes": {}, "launches": dict.fromkeys(KERNELS, 0),
                  "vae_steps": CANVAS_TRAIN_STEPS}
    need(ctrain["ok"], "canvas train path: " + ", ".join(ctrain["failures"]))
    for label, rs in ctrain["routes"].items():
        emit_histogram(f"{label}_fused_launch_shapes_step1", histogram(
            rs, lambda r: r.branch == "fused"))
    torch.cuda.empty_cache()

    mark("before path 5")
    # -- path 5: data parallelism, two ranks on the card over gloo --------
    try:
        dp = dp_phase(mp, dev, cap, power)
    except Exception:
        traceback.print_exc()
        dp = {"ok": False, "failures": ["data-parallel phase raised"],
              "counts": {}, "cases": {}, "kinds": {},
              "launches": dict.fromkeys(KERNELS, 0)}
    need(dp["ok"], "data-parallel path: " + ", ".join(dp["failures"]))
    torch.cuda.empty_cache()

    mark("before path 5b")
    # -- path 5b: tensor parallelism, a 2 x 2 mesh of four ranks on the card
    known = {k: {key for path, kernels in CHECKED_PATHS if k in kernels
                 for key in cap.case(path, k)} |
             {key for per in dp["cases"].values() for key in per.get(k, {})}
             for k in KERNELS}
    try:
        tp_ = tp_phase(mp, dev, cap, power, known)
    except Exception:
        traceback.print_exc()
        tp_ = {"ok": False, "failures": ["tensor-parallel phase raised"],
               "counts": {}, "cases": {}, "kinds": {},
               "launches": dict.fromkeys(KERNELS, 0)}
    need(tp_["ok"], "tensor-parallel path: " + ", ".join(tp_["failures"]))
    torch.cuda.empty_cache()

    mark("before path 6")
    # -- path 6: unbounded grids and the tensor API ------------------------
    try:
        with cap:
            unb = unbounded_phase(mp, dev, cap, power)
    except Exception:
        traceback.print_exc()
        unb = {"ok": False, "failures": ["unbounded phase raised"],
               "routes": [], "launches": {"B1": 0}}
    need(unb["ok"], "unbounded path: " + ", ".join(unb["failures"]))
    torch.cuda.empty_cache()

    mark("before path 7")
    # -- path 7: the model zoo's training entry points ----------------------
    try:
        with cap:
            zoo = zoo_phase(mp, dev, cap, power)
    except Exception:
        traceback.print_exc()
        zoo = {"ok": False, "failures": ["zoo phase raised"], "routes": {},
               "steps": {}, "launches": dict.fromkeys(KERNELS, 0)}
    need(zoo["ok"], "zoo path: " + ", ".join(zoo["failures"]))
    torch.cuda.empty_cache()

    mark("before path 8")
    # -- path 8: the data path and the utilities ----------------------------
    try:
        with cap:
            data = data_phase(mp, dev, cap, power)
    except Exception:
        traceback.print_exc()
        data = {"ok": False, "failures": ["data phase raised"], "routes": {},
                "launches": {}}
    need(data["ok"], "data path: " + ", ".join(data["failures"]))
    torch.cuda.empty_cache()

    mark("before path 10")
    # -- path 10: the quality and diagnosis entry points -------------------
    try:
        with cap:
            qual = quality_phase(mp, dev, cap, power)
    except Exception:
        traceback.print_exc()
        qual = {"ok": False, "failures": ["quality phase raised"],
                "routes": {}, "launches": {}}
    need(qual["ok"], "quality path: " + ", ".join(qual["failures"]))
    torch.cuda.empty_cache()

    mark("before kernels vs plain")
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
             for rs in (per_request_routes[0], canv["all_routes"],
                        train_routes, droutes, vae_off, diff_off,
                        unb["routes"], *ctrain["routes"].values(),
                        *zoo["routes"].values(), *data["routes"].values(),
                        *qual["routes"].values())
             for r in rs}
    for key, layer in {**tp_["kinds"], **dp["kinds"]}.items():
        kinds.setdefault(key, layer)
    check_all("B1", "generation", fused_check("B1", "main_path"), kinds)
    check_all("B1", "canvas", fused_check("B1", "canvas_path"), kinds)
    check_all("B1", "serve", fused_check("B1", "serve_path"), kinds)
    check_all("B1", "unbounded", fused_check("B1", "unbounded_path"), kinds)
    st = mp.sparse_tensor(torch.as_tensor(cpad, device=dev),
                          torch.as_tensor(valid, device=dev)[:, None].float(),
                          capacity=CAP, batch_size=BATCH,
                          valid=torch.as_tensor(valid, device=dev),
                          extent=(RES,) * 3)
    extras = [check_case(mp, *case) for case in extra_cases(mp, st, dev)]
    extras += canvas_dense_cases(mp, dev)
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
    # the canvas train path: the canvas VAE's shapes on float32 and on bf16
    # weights, and train.diffusion's with noise points under remat
    for path in ("canvas_vae", "canvas_vae_bf16", "noise_points"):
        for kernel in FUSED:
            check_all(kernel, path, fused_check(kernel, path), kinds)
    for kernel in BRICK:
        check_all(kernel, "noise_points", brick_check(kernel,
                                                      "noise_points"), kinds)
    # the DP and TP paths' launch shapes that no earlier path launched
    # (rank 0's operands, sent back to the card here)
    for path, per in list(dp["cases"].items()) + list(tp_["cases"].items()):
        for kernel, got in per.items():
            check = (brick_check if kernel in BRICK else fused_check)(
                kernel, path)
            for key, ops in sorted(got.items()):
                recs.setdefault((kernel, path), {})[key] = check(
                    key, tuple(o.to(dev) if torch.is_tensor(o) else o
                               for o in ops), kinds.get(key[:4], "?"))
    # the zoo's launch shapes that no earlier path launched, K = 125 (the
    # MinkUNet stem) and K = 8 (its k2s2 convs and pinned transposes)
    # among them
    for path in sorted(zoo["routes"]):
        for kernel in FUSED:
            known = {key for (k, _), got in recs.items() if k == kernel
                     for key in got}
            got = recs.setdefault((kernel, path), {})
            check = fused_check(kernel, path)
            for key, ops in sorted(cap.case(path, kernel).items()):
                if key not in known:
                    got[key] = check(key, ops, kinds.get(key[:4], "?"))
    # the data and quality phases' launch shapes that no earlier path
    # launched
    for path in sorted(data["launches"]) + sorted(qual["launches"]):
        for kernel in FUSED:
            known = {key for (k, _), got in recs.items() if k == kernel
                     for key in got}
            got = recs.setdefault((kernel, path), {})
            check = fused_check(kernel, path)
            for key, ops in sorted(cap.case(path, kernel).items()):
                if key not in known:
                    got[key] = check(key, ops, kinds.get(key[:4], "?"))
    all_recs = [r for got in recs.values() for r in got.values()] + extras
    emit({"kernel_checks": len(all_recs),
          "failed": [(r["kernel"], r["case"], r.get("forward_shape"))
                     for r in all_recs if not r["ok"]]})
    need(all(r["ok"] for r in all_recs), "kernel checks")

    # every launch shape of each path was checked
    def shapes(path, kernel):
        return set(cap.counts.get(path, {}).get(kernel, {}))
    for path, kernels in (("generation", ("B1",)), ("canvas", ("B1",)),
                          ("serve", ("B1",)), ("unbounded", ("B1",)),
                          ("vae_train", FUSED),
                          ("diffusion", KERNELS),
                          ("vae_gate_on", BRICK),
                          ("canvas_vae", FUSED), ("canvas_vae_bf16", FUSED),
                          ("noise_points", KERNELS)):
        for kernel in kernels:
            need(shapes(path, kernel) == set(recs[(kernel, path)]),
                 f"{kernel} checked at every launch shape of {path}")
    checked = {k: {key for (kk, _), got in recs.items() if kk == k
                   for key in got} for k in KERNELS}
    for path, per in list(dp["counts"].items()) + list(
            tp_["counts"].items()):
        for kernel, launched in per.items():
            need(set(launched) <= checked[kernel],
                 f"{kernel} checked at every launch shape of {path}")
    for path in zoo["routes"]:
        for kernel in FUSED:
            need(shapes(path, kernel) <= checked[kernel],
                 f"{kernel} checked at every launch shape of {path}")
    for path in list(data["launches"]) + list(qual["launches"]):
        for kernel in FUSED:
            need(shapes(path, kernel) <= checked[kernel],
                 f"{kernel} checked at every launch shape of {path}")
    for kernel in FUSED:
        for k in (125, 8):
            need(any(key[3] == k for path in zoo["routes"]
                     for key in shapes(path, kernel)),
                 f"{kernel} launched (and so checked) at K = {k} on the "
                 "zoo path")

    # per zoo train step: each launch shape's time x its launches (each
    # shape's record from whichever path checked it first)
    def first_rec(kernel, key):
        for (k, _), got in sorted(recs.items()):
            if k == kernel and key in got:
                return got[key]
        raise KeyError((kernel, key))
    zoo_account = {}
    for path, n in zoo["steps"].items():
        per = {k: cap.per_step(path, k, n) for k in FUSED}
        zoo_account[path] = {
            k: {"launches": sum(per[k].values()),
                **totals(per[k], {key: first_rec(k, key) for key in per[k]})}
            for k in FUSED}
    emit({"zoo_step_kernel_account": zoo_account, "card": power})
    # per dp x tp step on rank 0 (its same-batch step's launches)
    tp_account = {}
    for k in KERNELS:
        per = Counter(tp_["counts"].get("tp_same_batch", {}).get(k, {}))
        tp_account[k] = {"launches": sum(per.values()),
                         **totals(per, {key: first_rec(k, key)
                                        for key in per})}
    emit({"tp_step_kernel_account": tp_account, "card": power})

    # per request / step: each launch shape's time x its launches
    per_request = {"B1": by_shape(hist)}
    # every fused-route conv of a VAE step launches B1 and B3
    per_vae_step = {"B1": by_shape(hist_b3), "B2": by_shape(hist_b2),
                    "B3": by_shape(hist_b3)}
    per_diff_step = {n: cap.per_step("diffusion", n, DIFF_STEPS)
                     for n in KERNELS}
    tot = {"B1": totals(per_request["B1"], recs[("B1", "generation")])}
    per_canvas = by_shape(hist_canvas)
    tot_canvas = totals(per_canvas, recs[("B1", "canvas")])
    emit({"canvas_b1_per_request": {
        **tot_canvas, "launch_shapes": [
            {"shape": list(k), "count": c,
             "ms": recs[("B1", "canvas")][k]["ms"],
             "bound_ms": recs[("B1", "canvas")][k]["bound_ms"],
             "plain_ms": recs[("B1", "canvas")][k]["plain_ms"]}
            for k, c in sorted(per_canvas.items())]}})
    tot_vae = {n: totals(per_vae_step[n], recs[(n, "vae_train")])
               for n in FUSED}
    tot.update(B2=tot_vae["B2"], B3=tot_vae["B3"])
    emit({"vae_step_kernel_account": {
        n: {"ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"]} for n, t in tot_vae.items()},
        "ms_b1_b2_b3": sum(t["ms"] for t in tot_vae.values())})
    tot_diff = {n: totals(per_diff_step[n], recs[(n, "diffusion")])
                for n in KERNELS}
    # per canvas VAE step: each launch shape's time x its launches
    try:
        per_cvae = {n: cap.per_step("canvas_vae", n, ctrain["vae_steps"])
                    for n in FUSED}
    except AssertionError:
        need(False, "canvas VAE launches the same shapes at every step")
        per_cvae = {n: Counter() for n in FUSED}
    tot_cvae = {n: totals(per_cvae[n], recs[(n, "canvas_vae")])
                for n in FUSED}
    emit({"canvas_vae_step_kernel_account": {
        n: {"launches": sum(per_cvae[n].values()),
            "launch_shapes": [
                {"shape": list(k), "count": c,
                 "kind": kinds.get(k[:4], "?"),
                 "ms": recs[(n, "canvas_vae")][k]["ms"],
                 "plain_ms": recs[(n, "canvas_vae")][k]["plain_ms"],
                 "bound_ms": recs[(n, "canvas_vae")][k]["bound_ms"],
                 "ms_bf16_weight": recs[(n, "canvas_vae_bf16")].get(
                     k, {}).get("ms")}
                for k, c in sorted(per_cvae[n].items())],
            **tot_cvae[n]} for n in FUSED},
        "ms_b1_b2_b3": sum(t["ms"] for t in tot_cvae.values())})
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

    mark("before path 4")
    # -- path 4: the library path (bench_conv) ----------------------------
    try:
        lib = library_phase(mp, dev, power)
    except Exception:
        traceback.print_exc()
        lib = {"ok": False, "failures": ["library phase raised"], "recs": {},
               "launches": {}}
    need(lib["ok"], "library path: " + ", ".join(lib["failures"]))
    recs.update(lib["recs"])
    torch.cuda.empty_cache()

    mark("before path 9")
    # -- path 9: the fused conv's whole domain -----------------------------
    try:
        with cap:
            prec = precision_phase(mp, dev, cap, power)
    except Exception:
        traceback.print_exc()
        prec = {"ok": False, "failures": ["precision phase raised"],
                "recs": {}}
    need(prec["ok"], "precision path: " + ", ".join(
        map(str, prec["failures"])))
    recs.update(prec["recs"])
    torch.cuda.empty_cache()

    # the float32 diffusion comparisons' launch shapes that the precision
    # phase did not give: B5-f32, dF-f32 and B6-f32 with the gate on, B1-f32
    # with it off
    f32_diff = []
    try:
        for label in ("diffusion_f32", "diffusion_f32_step2"):
            for gate, bases in (("on", BRICK), ("off", ("B1",))):
                path = f"{label}_gate_{gate}"
                for base in bases:
                    kernel = f"{base}-f32"
                    known = {key for (k, _), got in recs.items()
                             if k == kernel for key in got}
                    got = recs.setdefault((kernel, path), {})
                    for key, ops in sorted(cap.case(path, base).items()):
                        if key in known:
                            continue
                        got[key] = (check_brick_launch(
                            mp, base, path, key, ops) if gate == "on" else
                            check_variant(mp, kernel, path, key, ops, "f32",
                                          kinds.get(key, "?")))
                        f32_diff.append(got[key])
                    need(shapes(path, base) <= known | set(got),
                         f"{kernel} checked at every launch shape of "
                         f"{path}")
    except Exception:
        traceback.print_exc()
        need(False, "float32 diffusion kernel checks")
    need(all(r["ok"] for r in f32_diff), "float32 diffusion kernel checks")
    torch.cuda.empty_cache()
    try:
        with cap:
            dom = domain_phase(mp, dev, cap, power)
    except Exception:
        traceback.print_exc()
        dom = {"ok": False, "failures": ["domain phase raised"], "recs": {}}
    need(dom["ok"], "domain path: " + ", ".join(dom["failures"]))
    recs.update(dom["recs"])
    torch.cuda.empty_cache()

    mark("before end-to-end references")
    # -- end-to-end references on a small input --------------------------
    for ref in (tiny_reference, tiny_canvas_reference, tiny_train_reference,
                tiny_diffusion_reference, tiny_zoo_reference):
        try:
            need(ref(mp, dev)["ok"], ref.__name__)
        except Exception:
            traceback.print_exc()
            need(False, ref.__name__)

    mark("end")
    emit({"unet_graph_fallbacks": fallbacks})
    need(not fallbacks, "every UNet forward captured as a CUDA graph where "
         "one engages (unet.graph_fallback 0)")
    emit({"card": power, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(power, flush=True)
    if failed:
        return fail("a phase failed (see the JSON lines above): " +
                    "; ".join(failed))

    def entry(name, launches, t, per):
        _, wrapper, source, replaces = {**KERNELS, **LIBRARY_KERNELS,
                                        **VARIANTS}[name]
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
        if name == "B1":
            e.update({"launches_canvas_path": canv["launches"]["B1"],
                      "launches_serve_path": serve["launches"]["B1"],
                      "launches_unbounded_path": unb["launches"]["B1"],
                      "ms_per_canvas_request": tot_canvas["ms"],
                      "plain_ms_per_canvas_request": tot_canvas["plain_ms"],
                      "bound_ms_per_canvas_request":
                          tot_canvas["bound_ms"]})
        e.update({"path": main_path,
                  "launches_dp_path_rank0": dp["launches"][name],
                  "launches_tp_path_rank0": tp_["launches"][name],
                  "ms_per_tp_step_rank0": tp_account[name]["ms"],
                  "ms_per_vae_step": tot_vae[name]["ms"],
                  "bound_ms_per_vae_step": tot_vae[name]["bound_ms"],
                  "launches_library_path": lib["launches"].get(name, 0),
                  "launches_vae_train_path": train_launches[name],
                  "launches_diffusion_path": diff["launches"][name],
                  "ms_per_diffusion_step": tot_diff[name]["ms"],
                  "bound_ms_per_diffusion_step": tot_diff[name]["bound_ms"],
                  "launches_canvas_train_path": ctrain["launches"][name],
                  "launches_zoo_path": zoo["launches"][name],
                  "launches_data_path": {
                      p: n[name] for p, n in data["launches"].items()},
                  "ms_per_zoo_step": {p: a[name]["ms"]
                                      for p, a in zoo_account.items()},
                  "bound_ms_per_zoo_step": {
                      p: a[name]["bound_ms"]
                      for p, a in zoo_account.items()},
                  "ms_per_canvas_vae_step": tot_cvae[name]["ms"],
                  "plain_ms_per_canvas_vae_step": tot_cvae[name]["plain_ms"],
                  "bound_ms_per_canvas_vae_step":
                      tot_cvae[name]["bound_ms"]})
        kernels.append(e)
    for name in BRICK:
        e = entry(name, diff["launches"][name], tot_diff[name],
                  "one diffusion train step")
        e["path"] = "diffusion"
        e["launches_canvas_train_path"] = ctrain["launches"][name]
        e["launches_dp_path_rank0"] = dp["launches"][name]
        e["launches_tp_path_rank0"] = tp_["launches"][name]
        e["ms_per_tp_step_rank0"] = tp_account[name]["ms"]
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
        if name == "B7":  # B4 at float32 compute runs this kernel
            e["counted_as"] = {"B4": "compute_dtype=float32",
                               **lib["b4_f32"]}
        if any("bound_fp32_ms" in r for r in got.values()):
            # the same bound with the float32 FMAs at the float32 peak
            e["bound_fp32_ms"] = sum(r.get("bound_fp32_ms", r["bound_ms"])
                                     for r in got.values())
        kernels.append(e)
    for name in VARIANTS:  # the float32 and 2-D variants
        if name in BRICK_F32:
            e = entry(name, prec["launches"][name], prec["per_step"][name],
                      "one float32 brick-gate-on step of "
                      "check_bf16_training")
            e["path"] = "precision_fp32_brick"
        elif name.endswith("-f32"):
            e = entry(name, prec["launches"][name], prec["per_step"][name],
                      "one float32 step of check_bf16_training")
            e["path"] = "precision_fp32"
        else:
            e = entry(name, dom["launches"][name], dom["per_part"][name],
                      "the 2-D part of the domain phase")
            e["path"] = "domain_2d"
        kernels.append(e)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def profile_run(label: str, run, wall_unprofiled: float) -> dict:
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
    rec = {"profile": label, "device_busy_s": busy_s,
           "profiler_records_lost": bc.profiled.lost,
           "profiler_sessions_refused": bc.profiled.refused,
           "device_kernels": sum(r[2] for r in rows),
           # B1 and B2 are one instantiation (B2's weight is cast
           # transposed), told apart only by their launches
           # (both variants: <BN, BK, TA, TB, stage 0>)
           "B1_and_B2_s": kernel_s(
               r"fused_sparse_conv_kernel<\d+, \d+, \d, \d, 0>"),
           "B3_s": kernel_s("fused_sparse_conv_dw::"),  # all its passes
           "B5_and_dF_s": kernel_s("brick_conv_kernel<"),
           "B6_s": kernel_s("brick_conv_dw::"),  # all its passes
           # PyTorch's elementwise kernels (casts among them)
           "elementwise_s": kernel_s("elementwise"),
           "wall_s_unprofiled": wall_unprofiled,
           "device_busy_share": busy_s / wall_unprofiled,
           "top_kernels": [{"name": n[:90], "device_ms": d / 1e3, "calls": c}
                           for d, n, c in rows[:20]]}
    emit(rec)
    return rec


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
