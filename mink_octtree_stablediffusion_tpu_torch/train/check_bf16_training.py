"""bf16-vs-float32 training-quality check: the VAE's loss curves under both
conv compute dtypes.  The counterpart of `scripts/check_bf16_training.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.train.check_bf16_training
    python -m mink_octtree_stablediffusion_tpu_torch.train.check_bf16_training \\
        --small --steps 3 --device cpu

Trains the same VAE twice from the same weights on a fixed 4-batch overfit
set of sphere shells (`train/vae_step_common.py`), once with the conv compute
dtype set to float32 and once to bf16 (``ops.set_default_compute_dtype``;
float32 parameters and accumulation in both, only the convs' products
change), and compares the BCE curves.  Pass: both runs optimize (the final
BCE below 0.7x the float32 run's first) and the bf16 final BCE lies within
``--tol`` (relative) of the float32 one.  Same flags and numbers as the
script (``--small``, ``--steps`` 200, ``--tol`` 0.15; full width: batch 4,
resolution 64, capacity 32,768, 60,000 points a shell, channels (32, 128,
512, 512, 4), encoder capacities (16384, 8192, 2048, 2048, 2048), decoder
capacities (2048, 8192, 16384, 32768), Adam at lr 1e-3, weights from seed
0, the reparameterisation noise from seed 1), plus ``--device`` (default:
the card).  Prints each run's curve, the final BCEs and ``BF16 TRAINING
OK``; exits non-zero when a check fails.

On the card both runs go through the fused conv's kernels: the float32 run
through B1/B2/B3's float32-accurate split-term instantiations, with TF32
off (``utils.device.resolve_device``), so that the dense routes compute
float32 too.  With the brick gate on (``ops.enable_brick_conv``), its
k3 s1 convs of ≤ 128 channels (the level-0 32→32 convs at 64³ × 4) take
the brick kernels, at float32 their split-term instantiations (B5-f32,
dF-f32, B6-f32).
"""

from __future__ import annotations

import argparse
import copy
import sys
import time
from collections import Counter

import numpy as np
import torch

from ..models.vae import VAE, vae_loss
from ..nn.conv import record_routes
from ..ops.conv import set_default_compute_dtype
from ..tensor import sparse_tensor
from ..utils.device import make_generator, resolve_device
from .optim import vae_optimizer
from .trainer import TrainState, make_train_step
from .vae_step_common import make_batch

ARMS = (("fp32", torch.float32), ("bf16", torch.bfloat16))
INIT_SEED, STEP_SEED, DATA_SEED, N_FIXED = 0, 1, 0, 4


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--small", action="store_true")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--tol", type=float, default=0.15)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def config(small: bool) -> dict:
    """The script's two sizes."""
    if small:
        return dict(b=2, res=16, cap=1024, pts=300,
                    channels=(8, 16, 16, 16, 4),
                    encoder_capacities=(512, 256, 64, 64, 64),
                    decoder_capacities=(64, 256, 512, 1024))
    return dict(b=4, res=64, cap=32768, pts=60000,
                channels=(32, 128, 512, 512, 4),
                encoder_capacities=(16384, 8192, 2048, 2048, 2048),
                decoder_capacities=(2048, 8192, 16384, 32768))


def setup(small: bool, device=None) -> dict:
    """The fixed batches (``RandomState(0)``, 4 of them) on the device and
    the VAE from seed 0, whose weights both runs start from."""
    dev = resolve_device(device)
    cfg = config(small)
    cs, vs = make_batch(np.random.RandomState(DATA_SEED), N_FIXED, cfg["b"],
                        cfg["cap"], cfg["res"], cfg["pts"])
    vae = VAE(channels=cfg["channels"],
              encoder_capacities=cfg["encoder_capacities"],
              decoder_capacities=cfg["decoder_capacities"], device=dev,
              seed=INIT_SEED)
    return dict(cfg=cfg, dev=dev, vae=vae,
                batches=[(torch.as_tensor(c, device=dev),
                          torch.as_tensor(v, device=dev))
                         for c, v in zip(cs, vs)])


def build_loss_fn(cfg: dict, dev):
    """The script's ``loss_fn``: ones as the input features, the VAE
    decoding against the input's own grid, ``vae_loss``."""
    cap, b, res = cfg["cap"], cfg["b"], cfg["res"]
    ones = torch.ones((cap, 1), device=dev)

    def loss_fn(model, batch, generator=None, eps=None):
        c, v = batch
        st = sparse_tensor(c, ones, capacity=cap, batch_size=b, valid=v,
                           extent=(res,) * 3)
        out_clss, targets, _, mean, log_var, _ = model(
            st, st.grid, eps=eps, generator=generator)
        return vae_loss(out_clss, targets, mean, log_var)

    return loss_fn


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_arm(env: dict, dtype, steps: int, log_every: int,
            eps=None) -> dict:
    """Train a copy of ``env``'s VAE for ``steps`` steps with the convs
    computing in ``dtype``: the BCE curve ``[(step, bce)]`` every
    ``log_every`` steps and at the last, every step's loss, each step's
    wall seconds (to a
    device sync), the first step's conv routes (``nn.record_routes``),
    whether TF32 was on, and ``one_more_step``, which runs a further step
    of the same run.  ``eps(i)``, where given, is step i's
    reparameterisation noise (else it is drawn from a generator seeded
    1)."""
    dev = env["dev"]
    vae = copy.deepcopy(env["vae"])
    state = TrainState(vae, vae_optimizer(vae.parameters(), 1e-3))
    step_fn = make_train_step(build_loss_fn(env["cfg"], dev))
    gen = make_generator(STEP_SEED, dev)

    def step(i):
        set_default_compute_dtype(dtype)
        try:
            batch = env["batches"][i % len(env["batches"])]
            kw = {"eps": eps(i)} if eps is not None else {"generator": gen}
            return step_fn(state, batch, **kw)
        finally:
            set_default_compute_dtype(None)

    curve, losses, walls, first = [], [], [], []
    for i in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        with record_routes() as routes:
            loss, aux = step(i)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
        first = first or routes
        if i % log_every == 0 or i == steps - 1:
            curve.append((i, float(aux["bce"])))
    tf32 = dev.type == "cuda" and bool(torch.backends.cuda.matmul.allow_tf32
                                       or torch.backends.cudnn.allow_tf32)
    return dict(curve=curve, losses=losses, walls=walls, routes=first,
                tf32=tf32, one_more_step=lambda: step(steps))


def verdict(curves: dict, tol: float) -> tuple:
    """(final BCE float32, final BCE bf16, their relative difference, the
    failed checks): the script's three asserts."""
    f32_final, bf16_final = curves["fp32"][-1][1], curves["bf16"][-1][1]
    f32_first = curves["fp32"][0][1]
    rel = abs(bf16_final - f32_final) / max(f32_final, 1e-8)
    failures = []
    if not f32_final < 0.7 * f32_first:
        failures.append("fp32 run failed to optimize")
    if not bf16_final < 0.7 * f32_first:
        failures.append("bf16 run failed to optimize")
    if not rel < tol:
        failures.append(f"bf16 diverged from fp32 by {rel:.1%}")
    return f32_final, bf16_final, rel, failures


def format_curve(name: str, curve) -> str:
    return f"{name}: " + "  ".join(f"{i}:{l:.4f}" for i, l in curve)


def main(argv=None) -> int:
    args = parse_args(argv)
    env = setup(args.small, args.device)
    log_every = max(args.steps // 10, 1)
    curves = {}
    for name, dtype in ARMS:
        out = run_arm(env, dtype, args.steps, log_every)
        curves[name] = out["curve"]
        print(format_curve(name, curves[name]), flush=True)
        print(f"{name} routes of a step: "
              f"{dict(Counter(r.branch for r in out['routes']))}",
              flush=True)
    f32_final, bf16_final, rel, failures = verdict(curves, args.tol)
    print(f"final BCE fp32={f32_final:.4f} bf16={bf16_final:.4f} "
          f"rel_diff={rel:.3f}")
    if failures:
        print("FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print("BF16 TRAINING OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
