"""A few Adam steps of `examples/train_vae.py` at its full widths, in the JAX
package and in the PyTorch port, from the same weights, batch and noise.

    JAX_PLATFORMS=cpu python tests/vae_steps_vs_jax.py          # 3 steps
    JAX_PLATFORMS=cpu python tests/vae_steps_vs_jax.py --steps 4 \\
        --input_capacity 16384 --batch_size 2

Both sides run on the CPU in float32: the JAX package through its XLA
gather path (`examples/train_vae.py`'s ``loss_fn`` and
``train.make_train_step``), the port through its plain versions
(``train.make_train_step``).  The port starts from the JAX weights
(``load_flax``) and gets the reparameterisation noise the JAX VAE draws.
The widths, Adam, its learning rate and ``kld_weight`` are train_vae.py's;
the input is cut to fit a CPU (by default 16384 input rows, a quarter of
65536, and 2 of its 4 synthetic shapes, with the `capacities()` schedule
of that input size).

Prints one JSON line per step and side: the loss, BCE and KLD of the step
(taken before its update) and the max and mean over valid latent rows of
the encoder's log-variance.  It shows whether the JAX package's own
training behaves as the port's does after the first Adam step.  Not a
test: it takes minutes and some GiB of memory.
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
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import mink_octtree_stablediffusion_tpu as mt  # noqa: E402
from mink_octtree_stablediffusion_tpu import models as mm  # noqa: E402
from mink_octtree_stablediffusion_tpu import train as mtrain  # noqa: E402
import mink_octtree_stablediffusion_tpu_torch as mp  # noqa: E402
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (  # noqa
    load_flax)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--input_capacity", type=int, default=16384)
    p.add_argument("--vae_channel", type=int, nargs=5,
                   default=[32, 128, 512, 512, 4])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--kld_weight", type=float, default=1e-6)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    cfg = parse_args(argv)
    res, b, cap = cfg.resolution, cfg.batch_size, cfg.input_capacity
    ch = tuple(cfg.vae_channel)
    enc, dec = mp.serve.capacities(cap)
    ds = mp.data.SyntheticShapes(resolution=res, num_samples=256)
    batch = mp.data.collate_pointclouds([ds[i]["coords"] for i in range(b)],
                                        cap, 200_000)[:3]
    print(json.dumps({"config": vars(cfg), "encoder_capacities": enc,
                      "decoder_capacities": dec,
                      "input_voxels": int(batch[1].sum())}), flush=True)

    def log_var_stats(mean_valid, log_var):
        v = mean_valid[:, None]
        return (jnp.where(v, log_var, -jnp.inf).max(),
                jnp.where(v, log_var, 0.0).sum() /
                jnp.maximum(v.sum() * log_var.shape[1], 1))

    jvae = mm.VAE(channels=ch, encoder_capacities=enc, decoder_capacities=dec)

    def build(cpad, valid, feats):
        return mt.sparse_tensor(cpad, feats, capacity=cap, batch_size=b,
                                valid=valid, extent=(res,) * 3)

    def loss_fn(params, batch_stats, batch, rng):  # examples/train_vae.py
        st = build(*batch)
        (out_clss, targets, sout, mean, log_var, _), upd = jvae.apply(
            {"params": params, "batch_stats": batch_stats}, st, st.grid, rng,
            mutable=["batch_stats"])
        loss, aux = mm.vae_loss(out_clss, targets, mean, log_var,
                                cfg.kld_weight)
        lv_max, lv_mean = log_var_stats(mean.valid, log_var.features)
        return loss, (dict(aux, log_var_max=lv_max, log_var_mean=lv_mean),
                      upd["batch_stats"])

    jbatch = tuple(jnp.asarray(a) for a in batch)
    rng = jax.random.PRNGKey(cfg.seed)
    st0 = jax.jit(build)(*jbatch)
    variables = jax.jit(jvae.init)(rng, st0, st0.grid, rng)
    state = mtrain.TrainState.create(variables["params"],
                                     variables["batch_stats"],
                                     mtrain.vae_optimizer(cfg.lr))
    jstep = mtrain.make_train_step(loss_fn)

    pvae = mp.models.VAE(channels=ch, encoder_capacities=enc,
                         decoder_capacities=dec, device="cpu")
    load_flax(pvae, variables)
    pstate = mp.train.TrainState(pvae, mp.train.vae_optimizer(
        pvae.parameters(), cfg.lr))

    def port_loss_fn(model, batch, eps):  # train.vae.build_loss_fn's
        cpad, valid, feats = (torch.as_tensor(a) for a in batch)
        st = mp.sparse_tensor(cpad, feats, capacity=cap, batch_size=b,
                              valid=valid, extent=(res,) * 3)
        out_clss, targets, _, mean, log_var, _ = model(st, st.grid, eps=eps)
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
        # the noise the JAX VAE draws from this step's key (`vae.py:160-162`)
        eps = jax.random.normal(jax.random.split(sub)[0], (enc[2], ch[4]))
        t0 = time.perf_counter()
        state, loss, aux = jstep(state, jbatch, sub)
        jax.block_until_ready(loss)
        t1 = time.perf_counter()
        ploss, paux = pstep(pstate, batch, torch.from_numpy(np.array(eps)))
        t2 = time.perf_counter()
        for side, l, a, s in (("jax", loss, aux, t1 - t0),
                              ("port", ploss, paux, t2 - t1)):
            print(json.dumps({"step": i + 1, "side": side, "loss": float(l),
                              **{k: float(v) for k, v in a.items()},
                              "wall_s": s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
