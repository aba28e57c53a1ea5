"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py               # from the root of a checkout
    python3 chip_smoke.py --profile     # also profile one request
    python3 chip_smoke.py --max-keep 0  # no decoder clamp (see MAX_KEEP)

Builds the port's CUDA kernels from `mink_octtree_stablediffusion_tpu_torch/
csrc/` and drives the port's main path — `serve.build_generate_fn` of
`examples/generate.py`'s default configuration with the DDIM scheduler
(resolution 128, batch 4, 65536 input rows, VAE (32, 128, 512, 512, 4),
UNet (4, 320, 640, 960) at full width, random weights from seed 0), cut to
8 DDIM steps — for 3 requests (seeds 0, 1, 2).  Then:

1. every kernel is held against its plain PyTorch version on the same
   bf16-rounded operands, at the shapes the main path gave it and at a few
   extra cases, within ``1e-3·max|ref| + 1e-5``, and timed (CUDA events,
   median of 25 after warm-up) beside its bound and its plain version;
2. the requests must give finite features and > 0 voxels per instance, and
   every conv that routed to the fused kernel must have launched it;
3. a tiny configuration runs on the card and on the CPU (plain versions
   under the same bf16 compute policy) with the same weights, inputs and
   noise: the encoder's latent, a UNet forward and a decoded voxel set must
   agree (tolerances in ``tiny_reference``).

The decoder clamps each level to ``MAX_KEEP`` rows (see there): with random
weights its growth would otherwise overflow the level buffers, and the
request check would fail.

Prints one JSON line per case and per request, the launch-shape histogram,
the card's name and power limit, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without CUDA or outside a checkout of the repository.
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
KERNEL_SOURCE = "mink_octtree_stablediffusion_tpu_torch/csrc/fused_sparse_conv.cu"
REPLACES = "mink_octtree_stablediffusion_tpu/ops/onehot_conv.py:553"


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


class Capture:
    """Wraps the conv layers' reference to the fused wrapper and keeps the
    operands of the first call of each launch shape (no extra launches)."""

    def __init__(self, mp):
        self.mod = mp.nn.conv
        self.orig = self.mod.fused_sparse_conv
        self.cases = {}
        self.on = False

    def __enter__(self):
        def wrapper(features, kernel, in_grid, out_grid, spec, bias=None,
                    compute_dtype=None):
            if self.on:
                key = (out_grid.capacity, features.shape[1], kernel.shape[2],
                       spec.volume)
                self.cases.setdefault(key, (features, kernel, in_grid,
                                            out_grid, spec))
            return self.orig(features, kernel, in_grid, out_grid, spec, bias,
                             compute_dtype)
        self.mod.fused_sparse_conv = wrapper
        return self

    def __exit__(self, *exc):
        self.mod.fused_sparse_conv = self.orig


def check_case(mp, name, kind, features, kernel, in_grid, out_grid, spec):
    """Kernel vs plain version on the same bf16-rounded operands; times."""
    import torch
    fc = mp.ops.fused_conv
    offs, s_in, cells = fc.conv_geometry(in_grid, spec)
    keys = in_grid.flat_keys()
    out = fc._launch(features, kernel, keys, out_grid.coords, out_grid.valid,
                     offs, s_in, cells, torch.bfloat16)
    f16, k16 = features.bfloat16().float(), kernel.bfloat16().float()

    def plain():
        return fc._fused_sparse_conv_plain(f16, k16, keys, out_grid.coords,
                                           out_grid.valid, offs, s_in, cells,
                                           torch.float32)
    ref = plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    ref_max = ref.abs().max().item() if ref.numel() else 0.0
    tol = 1e-3 * ref_max + 1e-5
    qk = fc.query_keys(out_grid.coords, out_grid.valid, offs, s_in, cells)
    pairs = int((fc.neighbor_index(keys, qk) >= 0).sum().item())
    n_in, cin = features.shape
    k, _, cout = kernel.shape
    n_out = out_grid.capacity
    flops = 2.0 * cin * cout * pairs
    nbytes = (4 * n_in * cin + 4 * k * cin * cout + 4 * n_in +
              4 * 4 * n_out + n_out + 4 * n_out * cout)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    ms = cuda_time_ms(lambda: fc._launch(features, kernel, keys,
                                         out_grid.coords, out_grid.valid,
                                         offs, s_in, cells, torch.bfloat16))
    plain_ms = cuda_time_ms(plain)
    rec = {"case": name, "kind": kind, "n_out": n_out, "n_in": n_in,
           "cin": cin, "cout": cout, "k": k, "matched_pairs": pairs,
           "max_abs_err": err, "max_abs_ref": ref_max, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes,
           "ok": bool(err <= tol and math.isfinite(err))}
    emit(rec)
    return rec


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


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", action="store_true")
    p.add_argument("--max-keep", type=int, default=MAX_KEEP,
                   help="decoder top-k clamp per level; 0 = none")
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
    logs = mp.utils.cuda_build.build([mp.ops.fused_conv.SOURCE])
    emit({"build_s": time.perf_counter() - t0,
          "ptxas": [ln.strip() for log in logs.values()
                    for ln in log.splitlines() if "Used" in ln
                    or "spill" in ln]})

    # -- main path: 3 requests of full-width generation ----------------
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
    kernel = mp.ops.fused_conv.fused_sparse_conv
    requests, per_request_routes = [], []
    with Capture(mp) as cap:
        kernel.launches = 0  # counts from here on are the main path's
        for seed in (0, 1, 2):
            cap.on = seed == 0
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
        main_launches = kernel.launches
    for h in hooks:
        h.remove()
    all_finite = bool(torch.stack(finite).all().item())
    emit({"main_path_launches": main_launches, "all_finite": all_finite})
    ok = ok and all_finite and main_launches > 0

    hist = Counter((r.n_out, r.cin, r.cout, r.k, r.layer)
                   for r in per_request_routes[0] if r.branch == "fused")
    dense_hist = Counter((r.n_out, r.cin, r.cout, r.k, r.layer)
                         for r in per_request_routes[0]
                         if r.branch == "dense")
    emit({"fused_launch_shapes_per_request": [
        {"n_out": k[0], "cin": k[1], "cout": k[2], "k": k[3], "kind": k[4],
         "count": c} for k, c in sorted(hist.items())]})
    emit({"dense_route_shapes_per_request": [
        {"n_out": k[0], "cin": k[1], "cout": k[2], "k": k[3], "kind": k[4],
         "count": c} for k, c in sorted(dense_hist.items())]})

    # -- kernel vs plain at the main path's shapes and extra cases -----
    cases = []
    kinds = {(r.n_out, r.cin, r.cout, r.k): r.layer
             for r in per_request_routes[0] if r.branch == "fused"}
    for key, (f, k, gi, go, spec) in sorted(cap.cases.items()):
        cases.append(check_case(mp, "main_path", kinds.get(key, "?"), f, k,
                                gi, go, spec))
    st = mp.sparse_tensor(torch.as_tensor(cpad, device=dev),
                          torch.as_tensor(valid, device=dev)[:, None].float(),
                          capacity=CAP, batch_size=BATCH,
                          valid=torch.as_tensor(valid, device=dev),
                          extent=(RES,) * 3)
    for case in extra_cases(mp, st, dev):
        cases.append(check_case(mp, *case))
    cases_ok = all(c["ok"] for c in cases)
    ok = ok and cases_ok and set(cap.cases) == {k[:4] for k in hist}

    # per-request totals of the kernel: sum over its launches of each
    # launch shape's measured time / bound / plain time
    by_shape = {(c["n_out"], c["cin"], c["cout"], c["k"]): c
                for c in cases if c["case"] == "main_path"}
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0.0,
           "bytes": 0.0}
    for key, count in hist.items():
        c = by_shape[key[:4]]
        tot["ms"] += count * c["ms"]
        tot["plain_ms"] += count * c["plain_ms"]
        tot["bound_ms"] += count * c["bound_ms"]
        tot["ops"] += count * c["bound_ops_ms"]
        tot["bytes"] += count * c["bound_bytes_ms"]

    # -- end-to-end reference on a small input --------------------------
    try:
        ref_ok = tiny_reference(mp, dev)["ok"]
    except Exception:
        traceback.print_exc()
        ref_ok = False
    ok = ok and ref_ok

    if args.profile:
        profile_request(fn, cpad, valid, dev,
                        statistics.median(r["wall_s"] for r in requests))

    emit({"card": power, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(power, flush=True)
    if not ok:
        return fail("a phase failed (see the JSON lines above)")
    emit({"kernels": [{
        "name": "fused_sparse_conv", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": main_launches,
        "launches_per_request": sum(hist.values()),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if tot["ops"] > tot["bytes"] else "bytes",
        "library_ms": None,
        "per": "one generation request (sum over its launches)"}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def profile_request(fn, cpad, valid, dev, wall_unprofiled: float) -> None:
    """Device time by kernel name for one request (torch.profiler).  The
    profiler slows the host down many times, so the device's busy share is
    taken against the wall time of an unprofiled request."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(9)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(cpad, valid, generator=gen)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    fused_s = sum(r[0] for r in rows if "fused_sparse_conv" in r[1]) / 1e6
    emit({"profile": "one request", "device_busy_s": busy_s,
          "device_kernels": sum(r[2] for r in rows),
          "fused_kernel_s": fused_s, "request_wall_s": wall_unprofiled,
          "device_busy_share": busy_s / wall_unprofiled,
          "top_kernels": [{"name": n[:90], "device_ms": d / 1e3, "calls": c}
                          for d, n, c in rows[:20]]})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
