"""3D shape generation: the counterpart of `examples/generate.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.generate \\
        --scheduler ddim --sample_steps 8 --export_dir artifact
    python -m mink_octtree_stablediffusion_tpu_torch.generate --device cpu \\
        --resolution 16 --input_capacity 256 --batch_size 2 \\
        --vae_channel 8 12 16 16 4 --unet_channel 4 8 16 16 --group 4 \\
        --sample_steps 1 --out_dir samples_tiny

Samples the latent diffusion model and decodes with the pruning VAE
decoder (the reference's validation sampling, `examples/diffusion.py:520-
658`): the latent coordinate set is fixed (the encoded `SyntheticShapes`
batch, or with ``--latent_mode all`` the full latent grid unioned in, as
`diffusion.py:548-552`), the features are denoised from N(0,1) over
``--sample_steps`` DDPM or DDIM steps, then the decoder re-grows the
octree.  Same flags and defaults as the example (resolution 128, batch 4,
65,536 input rows, VAE (32, 128, 512, 512, 4), UNet (4, 320, 640, 960),
group 32, 50 DDPM steps, seed 0), plus ``--device`` (default: the card).
``--vae_ckpt`` and ``--diffusion_ckpt`` are the port's own checkpoint
directories of ``train.vae`` and ``train.diffusion`` (their latest step);
without them the weights are random, from ``--seed``.  It logs the first
and the steady sampling time, renders ``<out_dir>/generated.png`` (one
panel per instance; matplotlib) and, with ``--export_dir``, writes a
serving artifact (``serve.save_artifact``) that ``serve.load_artifact``
serves.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch

from .data import SyntheticShapes, collate_pointclouds
from .diffusion import (DDIMScheduler, DDPMScheduler, inject_noise_points,
                        sample_latent)
from .serve import (build_generate_fn, capacities, generation_models,
                    save_artifact)
from .train.diffusion import load_vae_checkpoint
from .train.trainer import CheckpointManager
from .utils.device import make_generator, resolve_device

log = logging.getLogger("generate")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--vae_channel", type=int, nargs=5,
                   default=[32, 128, 512, 512, 4])
    p.add_argument("--unet_channel", type=int, nargs=4,
                   default=[4, 320, 640, 960])
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--diffusion_ckpt", type=str, default=None)
    p.add_argument("--vae_scale", type=float, default=0.1428)
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--scheduler", default="ddpm", choices=["ddpm", "ddim"])
    p.add_argument("--latent_mode", default="encoded",
                   choices=["encoded", "all"])
    p.add_argument("--group", type=int, default=32)
    p.add_argument("--attn_max_len", type=int, default=0,
                   help="0 = derive from latent capacity (must match "
                        "training so attention sees the same token sets)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="samples")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--input_capacity", type=int, default=65536)
    p.add_argument("--export_dir", type=str, default=None,
                   help="also write a serving artifact "
                        "(serve.save_artifact)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def load_unet_checkpoint(unet, directory: str, device) -> int:
    """Load the UNet of the latest ``train.diffusion`` checkpoint of
    ``directory`` (its model holds the UNet and the NLL); returns its
    step."""
    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no train.diffusion checkpoint in "
                                f"{directory}")
    payload = torch.load(mgr.path(step), map_location=device,
                         weights_only=True)
    unet.load_state_dict({k[len("unet."):]: v for k, v in
                          payload["model"].items() if k.startswith("unet.")})
    return step


def run(cfg) -> dict:
    """Everything but the render and the artifact: the models, the input
    batch and two sampling runs (seeds ``seed + 1`` and ``seed + 2``);
    returns the last output grid, the times and the generation function."""
    dev = resolve_device(cfg.device)
    b, cap, res = cfg.batch_size, cfg.input_capacity, cfg.resolution
    ds = SyntheticShapes(resolution=res, num_samples=64)
    vae, unet = generation_models(
        input_capacity=cap, batch_size=b, vae_channel=cfg.vae_channel,
        unet_channel=cfg.unet_channel, group=cfg.group,
        attn_max_len=cfg.attn_max_len, device=dev, seed=cfg.seed)
    if cfg.vae_ckpt:
        log.info("VAE from step %d", load_vae_checkpoint(vae, cfg.vae_ckpt,
                                                         dev))
    if cfg.diffusion_ckpt:
        log.info("UNet from step %d", load_unet_checkpoint(
            unet, cfg.diffusion_ckpt, dev))
    sched = (DDPMScheduler.create() if cfg.scheduler == "ddpm" else
             DDIMScheduler.create())
    cpad, valid, _, _ = collate_pointclouds(
        [ds[i]["coords"] for i in range(b)], cap)
    fn = build_generate_fn(vae, unet, sched, input_capacity=cap,
                           batch_size=b, resolution=res,
                           vae_scale=cfg.vae_scale,
                           sample_steps=cfg.sample_steps, device=dev)
    with torch.no_grad():
        st0, latent = fn.program.latent(
            torch.as_tensor(cpad, device=dev),
            torch.as_tensor(valid, device=dev))
        if cfg.latent_mode == "all":
            latent = inject_noise_points(
                latent, "all", max(res // 8, 1),
                capacity=capacities(cap)[0][2],
                generator=make_generator(cfg.seed, dev))

    @torch.no_grad()
    def sample(seed: int):
        z = sample_latent(unet, sched, latent,
                          num_inference_steps=cfg.sample_steps,
                          generator=make_generator(seed, dev))
        z = z.with_features(z.features / cfg.vae_scale)
        _, _, sout = vae.decode(z, st0.grid)
        return sout

    times = []
    for seed in (cfg.seed + 1, cfg.seed + 2):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sout = sample(seed)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    log.info("sampled %d voxels across %d instances; first %.2fs, steady "
             "%.3fs (%.4f s/sample)", int(sout.valid.sum()), b, times[0],
             times[1], times[1] / b)
    return {"sout": sout, "first_s": times[0], "steady_s": times[1],
            "fn": fn, "vae": vae, "unet": unet, "example": (cpad, valid)}


def main(argv=None) -> dict:
    cfg = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    out = run(cfg)
    from .utils.viz import render_pointclouds, sparse_tensor_clouds

    path = render_pointclouds(
        sparse_tensor_clouds(out["sout"], cfg.batch_size),
        os.path.join(cfg.out_dir, "generated.png"),
        resolution=cfg.resolution)
    log.info("wrote %s", path)
    if cfg.export_dir:
        d = save_artifact(cfg.export_dir, out["fn"], out["vae"].state_dict(),
                          out["unet"].state_dict(), example=out["example"])
        log.info("serving artifact written to %s", d)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
