"""The port's diffusion training path against the JAX package, on the CPU.

- ``coord_nll`` (value and the gradients in μ, Σ), ``add_noise`` with
  per-row timesteps, ``add_noise_per_instance`` and the three
  ``denoise_loss`` branches, at 1e-5 relative (float32).
- ``warmup_cosine`` against optax at steps across the warmup, the join and
  the cosine tail (1e-6 relative: optax computes in float32).
- ``diffusion_optimizer`` against ``optax.chain(clip_by_global_norm,
  adamw)`` over four updates, the first at lr 0 and one whose gradient
  norm engages the clipping (1e-6 relative).
- One tiny diffusion train step (the frozen tiny VAE's encode and a tiny
  UNet at resolution 128, as `test_torch_generate.py`; the same weights
  in both; JAX's timesteps and noise injected) against
  ``jax.value_and_grad`` of `examples/train_diffusion.py`'s ``loss_fn``:
  the loss within 1e-4 relative; the gradients of the UNet and the NLL
  within a relative RMS of 1e-4 at the median and 5e-3 at the worst
  tensor (``GRAD_RTOL_*``: float32 summation order only).
- The ``train.diffusion`` entry point at a tiny size: 3 steps, a
  checkpoint, and a resume that carries the schedule's position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import diffusion as md
from mink_octtree_stablediffusion_tpu import models as mm
from mink_octtree_stablediffusion_tpu import train as mtrain
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.train import diffusion as tdiff
from mink_octtree_stablediffusion_tpu_torch.utils import convert
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (from_flax,
                                                                  load_flax)

torch.set_num_threads(1)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


def _latents(rng, cap=256, bsz=3, ext=16, c=4):
    """The same latent (random voxels and features) in both packages."""
    coords = np.concatenate([rng.randint(0, bsz, (180, 1)),
                             rng.randint(0, ext, (180, 3))], 1).astype(
        np.int32)
    cpad, valid = mt.ops.pad_to_capacity(coords, cap)
    feats = rng.randn(cap, c).astype(np.float32)
    jl = jax.jit(lambda cc, v, f: mt.sparse_tensor(
        cc, f, capacity=cap, batch_size=bsz, valid=v, extent=(ext,) * 3))(
        jnp.asarray(cpad), jnp.asarray(valid), jnp.asarray(feats))
    pl = mp.sparse_tensor(_t(cpad), _t(feats), capacity=cap, batch_size=bsz,
                          valid=_t(valid), extent=(ext,) * 3)
    np.testing.assert_array_equal(_np(pl.grid.coords),
                                  np.asarray(jl.grid.coords))
    pl = pl.with_features(_t(jl.features))  # rows in the canonical order
    return jl, pl


def test_coord_nll_value_and_grad_match_jax(rng):
    jl, pl = _latents(rng, ext=32)
    mu = (rng.randn(3) * 0.2).astype(np.float32)
    a = rng.randn(3, 3).astype(np.float32) * 0.3
    sigma = (np.eye(3) + a @ a.T).astype(np.float32)
    ref, (gmu, gsig) = jax.value_and_grad(
        lambda m, s: md.coord_nll(md.CoordNLLParams(m, s), jl, 32),
        argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(sigma))
    p = mp.diffusion.CoordNLLParams()
    with torch.no_grad():
        p.mu.copy_(_t(mu))
        p.sigma.copy_(_t(sigma))
    got = mp.diffusion.coord_nll(p, pl, 32)
    got.backward()
    _rel(float(got), float(ref))
    _rel(_np(p.mu.grad), gmu)
    _rel(_np(p.sigma.grad), gsig)


@pytest.mark.parametrize("prediction_type",
                         ["epsilon", "v_prediction", "sample"])
def test_noising_and_denoise_loss_match_jax(rng, prediction_type):
    jl, pl = _latents(rng)
    noise = rng.randn(*jl.features.shape).astype(np.float32)
    out = rng.randn(*jl.features.shape).astype(np.float32)
    t = np.asarray([0, 517, 999], np.int32)
    jsched = md.DDPMScheduler.create()
    psched = mp.diffusion.DDPMScheduler.create()
    # per-row timesteps
    row_t = rng.randint(0, 1000, jl.capacity).astype(np.int32)
    _rel(_np(psched.add_noise(pl.features, _t(noise), _t(row_t))),
         jsched.add_noise(jl.features, jnp.asarray(noise),
                          jnp.asarray(row_t)))
    _rel(_np(psched.get_velocity(pl.features, _t(noise), _t(row_t))),
         jsched.get_velocity(jl.features, jnp.asarray(noise),
                             jnp.asarray(row_t)))
    jn = md.add_noise_per_instance(jsched, jl, jnp.asarray(t),
                                   jnp.asarray(noise))
    pn = mp.diffusion.add_noise_per_instance(psched, pl, _t(t), _t(noise))
    _rel(_np(pn.features), jn.features)
    ref = md.denoise_loss(jsched, jl.replace(features=jnp.asarray(out)), jl,
                          jnp.asarray(noise), jnp.asarray(t),
                          prediction_type)
    got = mp.diffusion.denoise_loss(psched, pl.with_features(_t(out)), pl,
                                    _t(noise), _t(t), prediction_type)
    _rel(float(got), float(ref))


def test_warmup_cosine_matches_optax():
    for base, warm, total, final in ((1e-4, 1000, 100_000, 0.0),
                                     (3e-3, 5, 40, 0.1), (1e-3, 0, 10, 0.0)):
        ref = mtrain.warmup_cosine(base, warm, total, final)
        got = mp.train.warmup_cosine(base, warm, total, final)
        for step in (0, 1, 2, warm - 1, warm, warm + 1, (warm + total) // 2,
                     total - 1, total, total + 7):
            np.testing.assert_allclose(got(step), float(ref(step)),
                                       rtol=1e-6, atol=1e-12)
    assert mp.train.warmup_cosine(1e-4, 1000, 100_000)(0) == 0.0


def test_diffusion_optimizer_matches_optax(rng):
    shapes = {"a": (3, 4), "b": (5,), "sigma": (3, 3)}
    params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    # gradient norms ~0.1, ~60 (clipped), ~0.1, ~0.01
    scales = (0.03, 20.0, 0.03, 0.003)
    grads = [{n: (rng.randn(*s) * sc).astype(np.float32)
              for n, s in shapes.items()} for sc in scales]
    tx = mtrain.diffusion_optimizer(1e-2, 2, 10)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    opt_state = tx.init(jp)
    tp = {n: torch.nn.Parameter(_t(v)) for n, v in params.items()}
    opt = mp.train.diffusion_optimizer(list(tp.values()), 1e-2, 2, 10)
    norms = []
    for i, g in enumerate(grads):
        norms.append(float(optax.global_norm(g)))
        upd, opt_state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in tp.items():
            p.grad = _t(g[n])
        opt.step()
        for n in shapes:
            np.testing.assert_allclose(_np(tp[n]), np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-7)
            if i == 0:  # lr 0: the first update moves nothing
                np.testing.assert_array_equal(_np(tp[n]), params[n])
    assert norms[1] > 0.5 > max(norms[0], norms[2], norms[3])
    assert opt.param_groups[0]["update_count"] == 4


RES, B, CAP = 128, 2, 4096
VCH, UCH, GROUP, SCALE = (8, 16, 32, 32, 4), (4, 8, 16, 16), 4, 0.1428
# Bounds on the relative RMS, port vs JAX, of the train step's gradients
# (float32 on both sides, the sums in another order).  Measured: median
# 2.9e-5 over the 478 tensors, worst 1.6e-3, on the instance-norm scales
# of the finest up-blocks, each a sum over thousands of rows whose terms
# largely cancel.  A layout or routing fault moves a gradient by a
# relative RMS of order one.
GRAD_RTOL_MEDIAN, GRAD_RTOL_MAX = 1e-4, 5e-3


def _flax_from_port(abstract, module):
    """A flax variables tree shaped like ``abstract`` (``jax.eval_shape``
    of ``init``: no compile) holding ``module``'s weights, through the
    mapping of ``utils.convert``."""
    sd = module.state_dict()

    def leaf(collection):
        def fn(path, x):
            names = tuple(str(p.key) for p in path)
            name, _ = convert._translate(collection, names,
                                         np.zeros(x.shape, np.float32))
            w = sd[name].numpy()
            return jnp.asarray(w.T if names[-1] == "kernel" and w.ndim == 2
                               else w)
        return fn
    return {c: jax.tree_util.tree_map_with_path(leaf(c), tree)
            for c, tree in abstract.items()}


def test_diffusion_train_step_matches_jax():
    """One train step of the port (``make_train_step`` over
    ``train.diffusion.build_loss_fn``) against ``jax.value_and_grad`` of
    the ``loss_fn`` of `examples/train_diffusion.py`, from the same
    weights (the port's, carried into flax trees shaped by
    ``jax.eval_shape``), input, timesteps and noise.  The gradients are
    compared after the optimizer's clipping, which scales them all by
    0.5 / ‖g‖ (the norm is far above 0.5 here)."""
    enc_caps, dec_caps = mp.serve.capacities(CAP)
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=B,
                                 points_per_shape=1500)
    cpad, valid, _, _ = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(B)], CAP)
    pvae, punet = mp.serve.generation_models(
        input_capacity=CAP, batch_size=B, vae_channel=VCH, unet_channel=UCH,
        group=GROUP, device="cpu", seed=3)
    jvae = mm.VAE(channels=VCH, encoder_capacities=enc_caps,
                  decoder_capacities=dec_caps)
    junet = mm.UNet(channels=UCH, group=GROUP,
                    attn_max_len=punet.block1_0.block1.attentions.max_len,
                    down_capacities=punet.down_capacities)
    sched = md.DDPMScheduler.create()

    def build(cpad, valid):
        feats = jnp.ones((CAP, 1)) * valid[:, None]
        return mt.sparse_tensor(cpad, feats, capacity=CAP, batch_size=B,
                                valid=valid, extent=(RES,) * 3)

    def encode(st, vv):  # examples/train_diffusion.py
        mean, _ = jvae.apply(vv, st, method=jvae.encode)
        return mean.with_features(jax.lax.stop_gradient(
            mean.features * SCALE))

    def loss_fn(params, latent, rng):  # examples/train_diffusion.py
        return md.diffusion_training_loss(
            lambda x, t, e: junet.apply({"params": params["unet"]}, x, t, e),
            sched, latent, rng, nll_params=params["nll"], resolution=RES)

    k = jax.random.PRNGKey(0)
    st0 = jax.jit(build)(jnp.asarray(cpad), jnp.asarray(valid))
    vae_vars = _flax_from_port(jax.eval_shape(jvae.init, k, st0, st0.grid, k),
                               pvae)
    # the example's loss encodes under stop_gradient inside the
    # differentiated function; encoding first gives the same gradients
    latent = jax.jit(encode)(st0, vae_vars)
    unet_vars = _flax_from_port(jax.eval_shape(
        junet.init, k, latent, jnp.zeros((B,), jnp.int32)), punet)
    params = {"unet": unet_vars["params"], "nll": md.CoordNLLParams.create()}
    rng = jax.random.PRNGKey(7)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, latent, rng)
    # the draws of `diffusion_training_loss` (`diffusion/module.py:116-119`)
    r_t, r_n = jax.random.split(rng)
    t = jax.random.randint(r_t, (B,), 0, sched.num_train_timesteps)
    noise = jax.random.normal(r_n, latent.features.shape)

    model = torch.nn.ModuleDict({"unet": punet,
                                 "nll": mp.diffusion.CoordNLLParams()})
    load_flax(model, {"params": params})  # the {"unet", "nll"} tree
    state = mp.train.TrainState(model, mp.train.diffusion_optimizer(
        model.parameters()))
    step = mp.train.make_train_step(tdiff.build_loss_fn(
        pvae, mp.diffusion.DDPMScheduler.create(), input_capacity=CAP,
        batch_size=B, resolution=RES, vae_scale=SCALE,
        prediction_type="epsilon", no_vae=False, device="cpu"))
    before = {n: p.clone() for n, p in model.state_dict().items()}
    with mp.nn.record_routes() as routes:
        ploss, paux = step(state, (cpad, valid), timesteps=_t(t),
                           noise=_t(noise))
    assert state.step == 1 and not pvae.training
    assert all(p.grad is None for p in pvae.parameters())
    assert {"fused", "dense"} <= {r.branch for r in routes}
    np.testing.assert_allclose(float(ploss), float(loss), rtol=1e-4)
    for key in ("denoise_loss", "nll_loss"):
        np.testing.assert_allclose(float(paux[key]), float(aux[key]),
                                   rtol=1e-4)
    norm = float(optax.global_norm(grads))
    assert norm > 0.5
    ref_grads = from_flax({"params": grads})
    named = dict(model.named_parameters())
    assert set(ref_grads) == set(named)
    rel = {}
    for name, ref in ref_grads.items():
        ref = ref * (0.5 / norm)
        got = named[name].grad
        assert got is not None, name
        rel[name] = float((got - ref).norm() / ref.norm().clamp(min=1e-30))
    worst = max(rel, key=rel.get)
    assert rel[worst] <= GRAD_RTOL_MAX, (worst, rel[worst])
    assert float(np.median(list(rel.values()))) <= GRAD_RTOL_MEDIAN
    # lr 0 at the first update: the step moved nothing
    for name, p in model.state_dict().items():
        assert torch.equal(p, before[name]), name


def test_train_diffusion_entry_point_runs_and_resumes(tmp_path, caplog):
    """`python -m ...train.diffusion` on the CPU at a tiny size: it trains,
    checkpoints at the step cap, and a second run resumes there with the
    schedule's position."""
    argv = ["--device", "cpu", "--resolution", "64", "--input_capacity",
            "2048", "--vae_channel", "4", "8", "8", "8", "4",
            "--unet_channel", "4", "8", "8", "8", "--group", "4",
            "--batch_size", "2", "--warmup", "2", "--ckpt_dir",
            str(tmp_path / "ck")]
    caplog.set_level("INFO", logger="train_diffusion")
    assert tdiff.main(argv + ["--steps", "2"]) == 0
    ckpt = mp.train.CheckpointManager(str(tmp_path / "ck"))
    assert ckpt.latest_step() == 2
    assert tdiff.main(argv + ["--steps", "3"]) == 0
    assert ckpt.latest_step() == 3
    assert "resumed at step 2" in caplog.text
    payload = torch.load(ckpt.path(3), weights_only=True)
    assert payload["optimizer"]["param_groups"][0]["update_count"] == 3
    assert {"unet", "nll"} == {k.split(".")[0] for k in payload["model"]}
    done = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("done")]
    assert len(done) == 2 and "nan" not in " ".join(done)
    for flags in (["--remat"], ["--val_every", "5"],
                  ["--noise_point_mode", "uniform"], ["--noise_near"]):
        with pytest.raises(NotImplementedError):
            tdiff.main(argv + flags)
