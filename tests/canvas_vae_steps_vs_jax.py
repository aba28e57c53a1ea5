"""Adam steps of the canvas VAE (`scripts/e2e_generalize.py` phase 1: the
VAE with ``latent_canvas``, clipping at 1.0, Adam on a 20-step warmup of a
6000-step cosine) in the JAX package and in the PyTorch port, from the
same weights, batch and noise.

    JAX_PLATFORMS=cpu python tests/canvas_vae_steps_vs_jax.py --steps 10
    JAX_PLATFORMS=cpu python tests/canvas_vae_steps_vs_jax.py --steps 10 \\
        --resolution 64 --vae_channel 16 64 256 256 4 --with_window_attn

Both sides run on the CPU in float32: the JAX package through its XLA
paths (the script's ``vae_loss_fn`` and ``train.make_train_step`` with its
optax chain), the port through its plain versions
(``VAE.forward``, ``vae_loss``, ``optim.canvas_vae_optimizer``).  The port
starts from the JAX weights (``load_flax``) and gets the
reparameterisation and canvas noise the JAX VAE draws from each step's key.
The input is a batch of `ProceduralShapes` (train split, seed 0,
``composite_prob`` 0.25), cut to ``--input_capacity`` rows with the
`capacities()` schedule of that size, the decoder's level 0 raised to the
batch's canvas.

Prints one JSON line per step and side: the loss, BCE and KLD of the step
(taken before its update) and the max and mean over valid latent rows of
the encoder's log-variance.  It shows whether the JAX package's canvas VAE
spikes where the port's does.  Not a test: it takes minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import mink_octtree_stablediffusion_tpu as mt  # noqa: E402
from mink_octtree_stablediffusion_tpu import models as mm  # noqa: E402
from mink_octtree_stablediffusion_tpu import train as mtrain  # noqa: E402
import mink_octtree_stablediffusion_tpu_torch as mp  # noqa: E402
from mink_octtree_stablediffusion_tpu_torch.train import (  # noqa: E402
    generalize)
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (  # noqa
    load_flax)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--points", type=int, default=32768)
    p.add_argument("--input_capacity", type=int, default=16384)
    p.add_argument("--vae_channel", type=int, nargs=5,
                   default=[32, 128, 512, 512, 4])
    p.add_argument("--with_window_attn", action="store_true")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--kld_weight", type=float, default=1e-6)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    cfg = parse_args(argv)
    res, b, cap = cfg.resolution, cfg.batch_size, cfg.input_capacity
    ch = tuple(cfg.vae_channel)
    cells = (res // 8) ** 3
    enc, dec = mp.serve.capacities(cap)
    dec = (max(dec[0], b * cells),) + tuple(dec[1:])
    ds = mp.data.ProceduralShapes(resolution=res, num_samples=b,
                                  points_per_shape=cfg.points, seed=0,
                                  composite_prob=0.25)
    batch = generalize.collate([ds[i] for i in range(b)], cap)[:3]
    print(json.dumps({"config": vars(cfg), "encoder_capacities": enc,
                      "decoder_capacities": dec,
                      "input_voxels": int(batch[1].sum())}), flush=True)

    jvae = mm.VAE(channels=ch, encoder_capacities=enc, decoder_capacities=dec,
                  latent_canvas=True, canvas_noise_std=1.0,
                  with_window_attn=cfg.with_window_attn)

    def build(cpad, valid, feats):
        return mt.sparse_tensor(cpad, feats, capacity=cap, batch_size=b,
                                valid=valid, extent=(res,) * 3)

    def loss_fn(params, batch_stats, batch, rng):  # the script's vae_loss_fn
        st = build(*batch)
        (out_clss, targets, _, mean, log_var, _), upd = jvae.apply(
            {"params": params, "batch_stats": batch_stats}, st, st.grid, rng,
            mutable=["batch_stats"])
        loss, aux = mm.vae_loss(out_clss, targets, mean, log_var,
                                cfg.kld_weight)
        v = mean.valid[:, None]
        lv = log_var.features
        return loss, (dict(aux, log_var_max=jnp.where(v, lv, -jnp.inf).max(),
                           log_var_mean=jnp.where(v, lv, 0.0).sum() /
                           jnp.maximum(v.sum() * lv.shape[1], 1)),
                      upd["batch_stats"])

    jbatch = tuple(jnp.asarray(a) for a in batch)
    rng = jax.random.PRNGKey(cfg.seed)
    st0 = jax.jit(build)(*jbatch)
    variables = jax.jit(jvae.init)(rng, st0, st0.grid, rng)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(mtrain.warmup_cosine(cfg.lr, 20, 6000)))
    state = mtrain.TrainState.create(variables["params"],
                                     variables["batch_stats"], tx)
    jstep = mtrain.make_train_step(loss_fn)

    pvae = mp.models.VAE(channels=ch, encoder_capacities=enc,
                         decoder_capacities=dec, latent_canvas=True,
                         canvas_noise_std=1.0,
                         with_window_attn=cfg.with_window_attn, device="cpu")
    load_flax(pvae, variables)
    pvae.train()
    pstate = mp.train.TrainState(pvae, mp.train.canvas_vae_optimizer(
        pvae.parameters(), cfg.lr, 6000))

    def port_loss_fn(model, batch, eps, canvas_noise):
        cpad, valid, feats = (torch.as_tensor(a) for a in batch)
        st = mp.sparse_tensor(cpad, feats, capacity=cap, batch_size=b,
                              valid=valid, extent=(res,) * 3)
        out_clss, targets, _, mean, log_var, _ = model(
            st, st.grid, eps=eps, canvas_noise=canvas_noise)
        loss, aux = mp.models.vae_loss(out_clss, targets, mean, log_var,
                                       cfg.kld_weight)
        v = mean.valid[:, None]
        lv = log_var.features
        return loss, dict(aux, log_var_max=lv.masked_fill(~v, -torch.inf)
                          .max(), log_var_mean=torch.where(v, lv, 0.0).sum()
                          / (v.sum() * lv.shape[1]).clamp(min=1))
    pstep = mp.train.make_train_step(port_loss_fn)

    for i in range(cfg.steps):
        rng, sub = jax.random.split(rng)
        # the VAE's draws from this step's key (`models/vae.py:160-166`,
        # `ops/canvas.py:63`)
        r_eps, r_canvas = jax.random.split(sub)
        eps = jax.random.normal(r_eps, (enc[2], ch[4]))
        cnoise = jax.random.normal(r_canvas, (b * cells, ch[4]))
        t0 = time.perf_counter()
        state, loss, aux = jstep(state, jbatch, sub)
        jax.block_until_ready(loss)
        t1 = time.perf_counter()
        ploss, paux = pstep(pstate, batch, torch.from_numpy(np.array(eps)),
                            torch.from_numpy(np.array(cnoise)))
        t2 = time.perf_counter()
        for side, l, a, s in (("jax", loss, aux, t1 - t0),
                              ("port", ploss, paux, t2 - t1)):
            print(json.dumps({"step": i + 1, "side": side, "loss": float(l),
                              **{k: float(v) for k, v in a.items()},
                              "wall_s": s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
