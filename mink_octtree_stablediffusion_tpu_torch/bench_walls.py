"""Wall time of a generation request and of a VAE train step on the card,
for comparing two checkouts of the port in one session.

    python3 mink_octtree_stablediffusion_tpu_torch/bench_walls.py \\
        --root <checkout> --label <name>

Imports the port from ``--root`` (default: this file's checkout), builds
its kernels, and times, each call ending in ``torch.cuda.synchronize()``:

- generation requests of ``chip_smoke.py``'s path 1 (``examples/
  generate.py``'s configuration at full width, DDIM cut to 8 steps, the
  decoder clamped at 2048, random weights from seed 0): one warm-up, then
  ``--requests`` timed (seeds 1, 2, ...);
- VAE train steps of ``examples/train_vae.py``'s defaults (Adam at 1e-3,
  batch 4 of `SyntheticShapes` at resolution 128): one warm-up, then
  ``--steps`` timed on the same batch;
- the host time of one fused conv call (``ops.fused_sparse_conv``, B1, a
  k3 s1 32→32 conv on the batch's 65,536-row input grid, no gradient):
  200 calls enqueued with no synchronisation, their host clock over 200,
  the median of 5 rounds;
- with ``--kernels``, the device time of B1, B2 and B3 in one request and
  one VAE step, and of B1–B3 and the brick kernels (B5, its dF pass, B6)
  in one VAE step with the brick gate on (``ops.enable_brick_conv``):
  every launch of the first timed request and steps is recorded at
  ``ops.fused_conv._launch`` / ``_launch_dkernel`` and
  ``ops.vol_conv._launch`` / ``_launch_dw`` (the launchers the operators
  call by module-global name), then run again alone, CUDA events, the
  median of 25 after 3, summed per kernel.

It uses only entry points that every checkout of the port since PR 6
has, so that a parent commit and a change run the same measurement.
Prints one JSON line with the walls, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(HERE))
    p.add_argument("--label", default="")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--kernels", action="store_true")
    args = p.parse_args(argv)
    # import the port of --root, not a module beside this file
    sys.path[:] = [os.path.abspath(args.root)] + [
        d for d in sys.path if os.path.abspath(d or ".") != HERE]
    import torch
    import mink_octtree_stablediffusion_tpu_torch as mp
    from mink_octtree_stablediffusion_tpu_torch.train import vae as tv

    if not torch.cuda.is_available():
        raise SystemExit("bench_walls: no CUDA device")
    dev = torch.device("cuda")
    mp.utils.cuda_build.build()
    res, batch, cap = 128, 4, 65536

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ds = mp.data.SyntheticShapes(resolution=res, num_samples=64)
    cpad, valid, feats, _ = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(batch)], cap)
    vae, unet = mp.serve.generation_models(
        input_capacity=cap, batch_size=batch, max_keep=2048, device=dev,
        seed=0)
    fn = mp.serve.build_generate_fn(
        vae, unet, mp.diffusion.DDIMScheduler.create(), input_capacity=cap,
        batch_size=batch, resolution=res, vae_scale=0.1428, sample_steps=8,
        device=dev)
    gen_walls = [timed(lambda s=s: fn(cpad, valid, generator=torch.Generator(
        device=dev).manual_seed(s))) for s in range(args.requests + 1)]
    kernels = {}
    if args.kernels:
        kernels["request"] = kernel_ms(mp, lambda: fn(
            cpad, valid, generator=torch.Generator(device=dev).manual_seed(1)))
    del vae, unet, fn
    torch.cuda.empty_cache()

    grid = mp.sparse_tensor(torch.as_tensor(cpad, device=dev),
                            torch.as_tensor(feats, device=dev),
                            capacity=cap, batch_size=batch,
                            valid=torch.as_tensor(valid, device=dev),
                            extent=(res,) * 3).grid
    f = torch.randn(cap, 32, device=dev)
    w = torch.randn(27, 32, 32, device=dev)
    spec = mp.ops.KernelSpec(3, 1, ndim=3)
    host_us = []
    with torch.no_grad():
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                mp.ops.fused_sparse_conv(f, w, grid, grid, spec)
            host_us.append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
    del grid, f, w

    enc_caps, dec_caps = mp.serve.capacities(cap)
    vae = mp.models.VAE(encoder_capacities=enc_caps,
                        decoder_capacities=dec_caps, device=dev,
                        seed=0).train()
    state = mp.train.TrainState(vae, mp.train.vae_optimizer(
        vae.parameters(), 1e-3))
    step = mp.train.make_train_step(tv.build_loss_fn(
        input_capacity=cap, batch_size=batch, resolution=res,
        kld_weight=1e-6, device=dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    vae_walls = [timed(lambda: step(state, (cpad, valid, feats), gen))
                 for _ in range(args.steps + 1)]
    if args.kernels:
        kernels["vae_step"] = kernel_ms(
            mp, lambda: step(state, (cpad, valid, feats), gen))
        mp.ops.enable_brick_conv(True)
        try:
            kernels["vae_step_gate_on"] = kernel_ms(
                mp, lambda: step(state, (cpad, valid, feats), gen))
        finally:
            mp.ops.enable_brick_conv(False)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    rec = {"label": args.label, "root": os.path.abspath(args.root),
           "torch": torch.__version__, "card": card,
           "gen_request_wall_s": gen_walls[1:],
           "gen_request_warmup_s": gen_walls[0],
           "vae_step_wall_s": vae_walls[1:],
           "vae_step_warmup_s": vae_walls[0],
           "b1_call_host_us": sorted(host_us[1:])[2],
           "kernel_ms": kernels}
    print(json.dumps(rec), flush=True)
    return rec


def event_ms(fn, warmup: int = 3, iters: int = 25) -> float:
    """Median ms of one call of ``fn`` on the card, CUDA events."""
    import statistics
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


def kernel_ms(mp, run) -> dict:
    """{kernel: {"launches", "ms"}} of one call of ``run``: each launch of
    B1 (``fused_conv._launch``), B2 (the same with ``transpose_weight``),
    B3 (``_launch_dkernel``), B5 (``vol_conv._launch``), its dF pass (the
    same with ``mirror``) and B6 (``_launch_dw``) recorded with its
    operands, then timed alone (``event_ms``) and summed per kernel."""
    import torch
    fc, vc = mp.ops.fused_conv, mp.ops.vol_conv
    launch, launch_dk = fc._launch, fc._launch_dkernel
    vlaunch, vlaunch_dw = vc._launch, vc._launch_dw
    calls = []

    def rec_launch(*a, **kw):
        name = "B2" if kw.get("transpose_weight") else "B1"
        calls.append((name, launch, a, kw))
        return launch(*a, **kw)

    def rec_launch_dk(*a, **kw):
        calls.append(("B3", launch_dk, a, kw))
        return launch_dk(*a, **kw)

    def rec_vlaunch(volp, kernel, mirror):
        calls.append(("B5-dF" if mirror else "B5", vlaunch,
                      (volp, kernel, mirror), {}))
        return vlaunch(volp, kernel, mirror)

    def rec_vlaunch_dw(*a):
        calls.append(("B6", vlaunch_dw, a, {}))
        return vlaunch_dw(*a)
    fc._launch, fc._launch_dkernel = rec_launch, rec_launch_dk
    vc._launch, vc._launch_dw = rec_vlaunch, rec_vlaunch_dw
    try:
        run()
        torch.cuda.synchronize()
    finally:
        fc._launch, fc._launch_dkernel = launch, launch_dk
        vc._launch, vc._launch_dw = vlaunch, vlaunch_dw
    out = {}
    for name, fn, a, kw in calls:
        got = out.setdefault(name, {"launches": 0, "ms": 0.0})
        got["launches"] += 1
        got["ms"] += event_ms(lambda: fn(*a, **kw))
    return out


if __name__ == "__main__":
    main()
