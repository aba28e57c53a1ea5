"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py               # from the root of a checkout
    python3 chip_smoke.py --profile     # also profile a request, a step
    python3 chip_smoke.py --max-keep 0  # no generation clamp (MAX_KEEP)

Builds the port's CUDA kernels from `mink_octtree_stablediffusion_tpu_torch/
csrc/` (one ``nvcc`` per source, all at once) and drives the port's two
paths, each with the kernels' launch counts set to 0 just before it and
read just after:

- **generation** — `serve.build_generate_fn` of `examples/generate.py`'s
  default configuration with the DDIM scheduler (resolution 128, batch 4,
  65536 input rows, VAE (32, 128, 512, 512, 4), UNet (4, 320, 640, 960) at
  full width, random weights from seed 0), cut to 8 DDIM steps, for 3
  requests (seeds 0, 1, 2).  Each request must give finite features and
  > 0 voxels per instance, and every fused-route conv must launch the
  forward kernel (B1).
- **training** — `examples/train_vae.py`'s default configuration (the same
  VAE with the `capacities()` schedule, Adam at lr 1e-3, ``kld_weight``
  1e-6, random weights from seed 0): 10 steps of ``train.make_train_step``
  on one fixed batch of 4 `SyntheticShapes` at resolution 128.  Every loss
  and gradient must be finite, every parameter must get a gradient, every
  fused-route conv must launch B1 and dW (B3) and, where its input carries
  a gradient, dF (B2), and the loss must fall (see ``train_phase``).

Then every kernel is held against its plain PyTorch version on the same
bf16-rounded operands, at the shapes its path gave it (B1 also at a few
extra cases; B2 and B3 with the captured cotangent scaled by a power of
two to unit RMS, see ``unit_rms``), within ``1e-3·max|ref| + 1e-5``, and
timed (CUDA events, median of 25 after warm-up) beside its bound and its
plain version.  Last,
tiny configurations run on the card and on the CPU (plain versions under
the same bf16 compute policy) with the same weights, inputs and noise: a
generation (``tiny_reference``) and one train step
(``tiny_train_reference``) must agree within the tolerances stated there.

The generation decoder clamps each level to ``MAX_KEEP`` rows (see there);
training runs unclamped (see ``train_phase``).

Prints one JSON line per case, request and step, the launch-shape
histograms, the card's name and power limit, a ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
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
CSRC = "mink_octtree_stablediffusion_tpu_torch/csrc/"
JAX_CONV = "mink_octtree_stablediffusion_tpu/ops/onehot_conv.py"
# kernel: (wrapper in ops/fused_conv.py, source, the TPU kernel it replaces)
KERNELS = {
    "B1": ("fused_sparse_conv", CSRC + "fused_sparse_conv.cu",
           JAX_CONV + ":553"),  # _fused_impl, pallas_call :831
    "B2": ("fused_conv_dfeatures", CSRC + "fused_sparse_conv.cu",
           JAX_CONV + ":1186"),  # _fused_impl on _FusedStatic.flipped
    "B3": ("fused_conv_dkernel", CSRC + "fused_sparse_conv_dw.cu",
           JAX_CONV + ":935"),  # _dkernel_fused, pallas_call :1146
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_time_ms(fn, warmup: int = 3, iters: int = 25) -> float:
    """Median per-call time of ``fn`` in ms (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "n/a"


def decoder_levels(out_clss, batch: int) -> list:
    """Candidate rows per instance at each decoder level, with the level's
    buffer capacity (a level whose rows fill its buffer has overflowed)."""
    import torch
    return [{"capacity": lt.capacity,
             "rows_per_instance": torch.bincount(
                 lt.grid.coords[lt.valid][:, 0].long(),
                 minlength=batch).tolist()} for lt in out_clss]


class LaunchCapture:
    """Wraps the launchers of B1 and B2 (``_launch``, B2 with
    ``transpose_weight``) and B3 (``_launch_dkernel``) and keeps the
    operands (features or cotangent, weight or cotangent, keys, output
    coordinates and valid mask, offsets, stride, cells) of the first call
    of each launch shape, keyed by the forward conv's (N_out, Cin, Cout, K),
    for the kernels named in ``on`` (no extra launches)."""

    def __init__(self, fc):
        self.fc = fc
        self.orig = (fc._launch, fc._launch_dkernel)
        self.cases = {name: {} for name in KERNELS}
        self.on = ()

    def keep(self, name, key, ops):
        if name in self.on:
            self.cases[name].setdefault(key, ops)

    def __enter__(self):
        launch, launch_dkernel = self.orig

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

        self.fc._launch, self.fc._launch_dkernel = b1_b2, b3
        return self

    def __exit__(self, *exc):
        self.fc._launch, self.fc._launch_dkernel = self.orig


def unit_rms(g):
    """``g`` times the power of two that brings its RMS nearest 1.  B2 and
    B3 are linear in the cotangent, and a power-of-two scale commutes with
    bf16 rounding and float32 sums, so the kernels are checked on the
    captured operands up to an exact scale.  Step 1's cotangents are tiny
    (an RMS of 1e-9 to 1e-4), and unscaled the ``1e-5`` term of the
    tolerance would pass a kernel that returned zeros."""
    rms = g.square().mean().sqrt().item()
    return (g * 2.0 ** -round(math.log2(rms)) if rms > 0 else g), rms


def matched_pairs(fc, keys, out_coords, out_valid, offs, s, cells) -> int:
    qk = fc.query_keys(out_coords, out_valid, offs, s, cells)
    return int((fc.neighbor_index(keys, qk) >= 0).sum().item())


def timed_check(kernel, case, kind, run, plain, pairs, cin, cout, nbytes,
                min_ref=0.0, **shape):
    """Kernel vs plain version: max|Δ| ≤ 1e-3·max|ref| + 1e-5, and max|ref|
    ≥ ``min_ref`` (so that a kernel returning zeros fails); CUDA-event
    times of both; the bound max(2·Cin·Cout·pairs / peak bf16, bytes /
    peak HBM)."""
    import torch
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    ref_max = ref.abs().max().item() if ref.numel() else 0.0
    tol = 1e-3 * ref_max + 1e-5
    flops = 2.0 * cin * cout * pairs
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    rec = {"kernel": kernel, "case": case, "kind": kind, **shape,
           "cin": cin, "cout": cout, "matched_pairs": pairs,
           "max_abs_err": err, "max_abs_ref": ref_max, "tol": tol,
           "rel_err": err / ref_max if ref_max else 0.0,
           "ms": cuda_time_ms(run), "plain_ms": cuda_time_ms(plain),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes,
           "ok": bool(err <= tol and math.isfinite(err) and
                      ref_max >= min_ref)}
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


def shape_totals(hist, cases) -> dict:
    """Sum over a path's launches (``hist``: launch shape → count) of each
    launch shape's measured time, plain time and bound."""
    by_shape = {(c["n_out"], c["cin"], c["cout"], c["k"]): c for c in cases}
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0.0,
           "bytes": 0.0}
    for key, count in hist.items():
        c = by_shape[key[:4]]
        tot["ms"] += count * c["ms"]
        tot["plain_ms"] += count * c["plain_ms"]
        tot["bound_ms"] += count * c["bound_ms"]
        tot["ops"] += count * c["bound_ops_ms"]
        tot["bytes"] += count * c["bound_bytes_ms"]
    return tot


def histogram(routes, keep) -> Counter:
    return Counter((r.n_out, r.cin, r.cout, r.k, r.layer) for r in routes
                   if keep(r))


def emit_histogram(label, hist) -> None:
    emit({label: [{"n_out": k[0], "cin": k[1], "cout": k[2], "k": k[3],
                   "kind": k[4], "count": c}
                  for k, c in sorted(hist.items())]})


def counters(mp) -> dict:
    fc = mp.ops.fused_conv
    return {name: getattr(fc, wrapper)
            for name, (wrapper, _, _) in KERNELS.items()}


def train_phase(mp, dev, cap):
    """10 steps of `examples/train_vae.py`'s default configuration through
    ``train.make_train_step``, on one fixed batch of 4 synthetic shapes;
    ``cap`` keeps step 1's B2 and B3 operands.

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
    one more step)."""
    import torch
    from mink_octtree_stablediffusion_tpu_torch.train import vae as tv
    enc, dec = mp.serve.capacities(CAP)
    t0 = time.perf_counter()
    vae = mp.models.VAE(channels=VAE_CH, encoder_capacities=enc,
                        decoder_capacities=dec, device=dev, seed=0)
    state = mp.train.TrainState(vae, mp.train.vae_optimizer(
        vae.parameters(), TRAIN_LR))
    step = mp.train.make_train_step(tv.build_loss_fn(
        input_capacity=CAP, batch_size=BATCH, resolution=RES,
        kld_weight=TRAIN_KLD, device=dev))
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=256)
    batch = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(BATCH)], CAP, 200_000)[:3]
    gen = torch.Generator(device=dev).manual_seed(0)
    emit({"train_model_built_s": time.perf_counter() - t0,
          "vae_params": sum(p.numel() for p in vae.parameters()),
          "input_voxels": int(batch[1].sum()), "max_keep": None})
    outputs = []  # (out_clss, mean, log_var) of each forward
    hook = vae.register_forward_hook(
        lambda m, i, o: outputs.append((o[0], o[3], o[4])))
    count = counters(mp)
    steps, first_routes, ok = [], None, True
    for c in count.values():
        c.launches = 0  # counts from here on are the train path's
    for i in range(TRAIN_STEPS):
        cap.on = ("B2", "B3") if i == 0 else ()
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
        ok = ok and finite and not missing and launched == {
            "B1": len(fused), "B2": rec["fused_with_input_grad"],
            "B3": len(fused)}
    cap.on = ()
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
            lambda: step(state, batch, generator=gen))


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

    def rel_rms(a, ref):
        return {n: float((a[n] - ref[n]).norm() / ref[n].norm().clamp(
            min=1e-30)) for n in ref}
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
    power = nvidia_smi()
    ok = True

    # -- build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = mp.utils.cuda_build.build(mp.ops.fused_conv.SOURCES)
    emit({"build_s": time.perf_counter() - t0,
          "ptxas": [ln.strip() for log in logs.values()
                    for ln in log.splitlines() if "Used" in ln
                    or "spill" in ln]})

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
    cap = LaunchCapture(mp.ops.fused_conv)
    with cap:
        for c in count.values():
            c.launches = 0  # counts from here on are the generation path's
        for seed in (0, 1, 2):
            cap.on = ("B1",) if seed == 0 else ()
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
            if min(per_inst) <= 0 or launched != len(fused):
                ok = False
        gen_launches = {n: c.launches for n, c in count.items()}
    for h in hooks:
        h.remove()
    all_finite = bool(torch.stack(finite).all().item())
    emit({"generation_path_launches": gen_launches,
          "all_finite": all_finite})
    # generation runs no backward: B2 and B3 must not launch there
    ok = (ok and all_finite and gen_launches["B1"] > 0 and
          gen_launches["B2"] == gen_launches["B3"] == 0)
    hist = histogram(per_request_routes[0], lambda r: r.branch == "fused")
    emit_histogram("fused_launch_shapes_per_request", hist)
    emit_histogram("dense_route_shapes_per_request", histogram(
        per_request_routes[0], lambda r: r.branch == "dense"))

    # -- path 2: 10 steps of full-width VAE training --------------------
    with cap:
        train_ok, steps, train_routes, train_launches, one_more_step = \
            train_phase(mp, dev, cap)
    ok = ok and train_ok
    hist_b3 = histogram(train_routes, lambda r: r.branch == "fused")
    hist_b2 = histogram(train_routes,
                        lambda r: r.branch == "fused" and r.grad_in)
    emit_histogram("train_fused_launch_shapes_per_step", hist_b3)

    # -- kernels vs plain at their paths' shapes (and B1's extra cases) --
    cases = []
    kinds = {(r.n_out, r.cin, r.cout, r.k): r.layer
             for r in per_request_routes[0] if r.branch == "fused"}
    for key, ops in sorted(cap.cases["B1"].items()):
        cases.append(check_conv_launch(mp, "B1", "main_path",
                                       kinds.get(key, "?"), ops))
    st = mp.sparse_tensor(torch.as_tensor(cpad, device=dev),
                          torch.as_tensor(valid, device=dev)[:, None].float(),
                          capacity=CAP, batch_size=BATCH,
                          valid=torch.as_tensor(valid, device=dev),
                          extent=(RES,) * 3)
    for case in extra_cases(mp, st, dev):
        cases.append(check_case(mp, *case))
    train_kinds = {k[:4]: k[4] for k in hist_b3}
    # a B2 record carries its launch's own shape (N_out = the forward's
    # N_in, Cin and Cout swapped) and the forward conv's shape
    b2_cases = [check_conv_launch(mp, "B2", "train_path", train_kinds[key],
                                  ops, transpose_weight=True,
                                  forward_shape=list(key))
                for key, ops in sorted(cap.cases["B2"].items())]
    b3_cases = [check_dkernel_launch(mp, "train_path", train_kinds[key], ops)
                for key, ops in sorted(cap.cases["B3"].items())]
    ok = (ok and all(c["ok"] for c in cases + b2_cases + b3_cases) and
          set(cap.cases["B1"]) == {k[:4] for k in hist} and
          set(cap.cases["B2"]) == {k[:4] for k in hist_b2} and
          set(cap.cases["B3"]) == {k[:4] for k in hist_b3})
    tot = shape_totals(hist, [c for c in cases if c["case"] == "main_path"])
    tot2 = shape_totals(hist_b2, [dict(c, n_out=c["forward_shape"][0],
                                       cin=c["forward_shape"][1],
                                       cout=c["forward_shape"][2])
                                  for c in b2_cases])
    tot3 = shape_totals(hist_b3, b3_cases)

    # -- end-to-end references on a small input --------------------------
    for ref in (tiny_reference, tiny_train_reference):
        try:
            ref_ok = ref(mp, dev)["ok"]
        except Exception:
            traceback.print_exc()
            ref_ok = False
        ok = ok and ref_ok

    if args.profile:
        gen = torch.Generator(device=dev).manual_seed(9)
        profile_run("one request", lambda: fn(cpad, valid, generator=gen),
                    statistics.median(r["wall_s"] for r in requests[1:]))
        profile_run("one VAE train step", one_more_step,
                    statistics.median(r["wall_s"] for r in steps[1:]))

    emit({"card": power, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(power, flush=True)
    if not ok:
        return fail("a phase failed (see the JSON lines above)")

    def entry(name, launches, per, t, all_cases, per_what):
        wrapper, source, replaces = KERNELS[name]
        return {"name": f"{name} {wrapper}", "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": launches, per_what: per,
                "max_abs_err": max(c["max_abs_err"] for c in all_cases),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": "operations" if t["ops"] > t["bytes"]
                else "bytes", "library_ms": None,
                "per": ("one generation request" if name == "B1" else
                        "one VAE train step") + " (sum over its launches)"}
    emit({"kernels": [
        dict(entry("B1", gen_launches["B1"], sum(hist.values()), tot, cases,
                   "launches_per_request"),
             launches_train_path=train_launches["B1"]),
        entry("B2", train_launches["B2"], sum(hist_b2.values()), tot2,
              b2_cases, "launches_per_step"),
        entry("B3", train_launches["B3"], sum(hist_b3.values()), tot3,
              b3_cases, "launches_per_step")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def profile_run(label: str, run, wall_unprofiled: float) -> None:
    """Device time by kernel name for one call of ``run`` (torch.profiler).
    The profiler slows the host down many times, so the device's busy
    share is taken against the wall time of an unprofiled call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6

    def kernel_s(*names):
        return sum(r[0] for r in rows if all(n in r[1] for n in names)) / 1e6
    emit({"profile": label, "device_busy_s": busy_s,
          "device_kernels": sum(r[2] for r in rows),
          "B1_s": kernel_s("fused_sparse_conv_kernel<false>"),
          "B2_s": kernel_s("fused_sparse_conv_kernel<true>"),
          "B3_s": kernel_s("fused_sparse_conv_dw_kernel"),
          "wall_s_unprofiled": wall_unprofiled,
          "device_busy_share": busy_s / wall_unprofiled,
          "top_kernels": [{"name": n[:90], "device_ms": d / 1e3, "calls": c}
                          for d, n, c in rows[:20]]})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
