"""The port's generation path against the JAX package at tiny widths.

One tiny configuration of `examples/generate.py` (VAE with the
`capacities()` schedule, UNet with the latent-derived attention length and
down capacities; resolution 128 so that the UNet's stride-8 convs take the
fused route and its coarsest level still holds several voxels per
instance).  JAX initialises the weights; `utils.convert.load_flax` carries
them over.  The decoder's occupancy heads are scaled ×100, which spreads
the logits so that no top-k decision lies within 1e-3 of its threshold.  JAX's random draws of `sample_latent` are rebuilt here
with the same `split` sequence and handed to the port.  float32
throughout; features are compared at 1e-4 of max|ref|.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import diffusion as md
from mink_octtree_stablediffusion_tpu import models as mm
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.utils.convert import load_flax

torch.set_num_threads(1)

RES, B, CAP, STEPS = 128, 2, 4096, 2
VCH, UCH, GROUP = (8, 16, 32, 32, 4), (4, 8, 16, 16), 4
SCALE = 0.1428


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _jax_noise(key, shape, steps):
    """`sample_latent`'s draws: r0 → initial noise, then one split per
    step (`diffusion/module.py:154-172`)."""
    r0, key = jax.random.split(key)
    init = jax.random.normal(r0, shape)
    step_noises = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        step_noises.append(torch.as_tensor(np.array(
            jax.random.normal(sub, shape))))
    return torch.as_tensor(np.array(init)), step_noises


@pytest.fixture(scope="module")
def setup():
    spec = importlib.util.spec_from_file_location(
        "train_vae_example",
        pathlib.Path(__file__).resolve().parents[1] / "examples/train_vae.py")
    train_vae = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_vae)
    enc_caps, dec_caps = train_vae.capacities(CAP)
    assert (enc_caps, dec_caps) == mp.serve.capacities(CAP)

    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=B,
                                 points_per_shape=1500)
    jds = mt.data.SyntheticShapes(resolution=RES, num_samples=B,
                                  points_per_shape=1500)
    cpad, valid, _, _ = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(B)], CAP)
    jcpad, jvalid, _, _ = mt.data.collate_pointclouds(
        [jds[i]["coords"] for i in range(B)], CAP)
    np.testing.assert_array_equal(cpad, jcpad)

    pvae, punet = mp.serve.generation_models(
        input_capacity=CAP, batch_size=B, vae_channel=VCH, unet_channel=UCH,
        group=GROUP, device="cpu")
    jvae = mm.VAE(channels=VCH, encoder_capacities=enc_caps,
                  decoder_capacities=dec_caps)
    junet = mm.UNet(channels=UCH, group=GROUP,
                    attn_max_len=punet.time_embedding and
                    punet.block1_0.block1.attentions.max_len,
                    down_capacities=punet.down_capacities)
    feats = jnp.ones((CAP, 1)) * jnp.asarray(valid)[:, None]
    st = jax.jit(lambda c, v: mt.sparse_tensor(
        c, feats, capacity=CAP, batch_size=B, valid=v,
        extent=(RES,) * 3))(jnp.asarray(cpad), jnp.asarray(valid))
    k = jax.random.PRNGKey(0)
    vae_vars = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 100.0 if str(p[-2].key).endswith("_cls") and
        str(p[-1].key) == "kernel" else x,
        jax.jit(jvae.init)(k, st, st.grid, k))
    jlatent = jax.jit(lambda v, s: jvae.apply(
        {"params": v["params"], "batch_stats": v["batch_stats"]}, s,
        method=jvae.encode)[0])(vae_vars, st)
    unet_vars = jax.jit(junet.init)(k, jlatent, jnp.zeros((B,), jnp.int32))
    load_flax(pvae, vae_vars)
    load_flax(punet, unet_vars)
    pst = mp.sparse_tensor(torch.as_tensor(cpad), torch.ones(CAP, 1) *
                           torch.as_tensor(valid)[:, None], capacity=CAP,
                           batch_size=B, valid=torch.as_tensor(valid),
                           extent=(RES,) * 3)
    return dict(cpad=cpad, valid=valid, st=st, pst=pst, jvae=jvae,
                junet=junet, pvae=pvae, punet=punet, vae_vars=vae_vars,
                unet_vars=unet_vars, jlatent=jlatent)


def test_encode_and_unet_forward_match_jax(setup):
    s = setup
    pmean, _ = s["pvae"].encode(s["pst"])
    np.testing.assert_array_equal(_np(pmean.grid.coords),
                                  np.asarray(s["jlatent"].grid.coords))
    _close(_np(pmean.features), s["jlatent"].features)
    t = jnp.asarray([999, 37], jnp.int32)
    junet = s["junet"]
    ref = jax.jit(lambda p, x, t: junet.apply(p, x, t, train=False)
                  .features)(s["unet_vars"], s["jlatent"], t)
    platent = pmean.with_features(torch.as_tensor(
        np.array(s["jlatent"].features)))
    with mp.nn.record_routes() as routes:
        got = s["punet"](platent, torch.as_tensor(np.array(t)))
    _close(_np(got.features), ref)
    branches = {r.branch for r in routes}
    assert {"fused", "dense"} <= branches, branches


def test_ddim_two_steps_matches_jax(setup):
    s = setup
    sched = md.DDIMScheduler.create()
    junet = s["junet"]
    latent = s["jlatent"].replace(features=s["jlatent"].features * SCALE)
    key = jax.random.PRNGKey(3)
    ref = jax.jit(lambda p, lat, k: md.sample_latent(
        lambda x, t, e: junet.apply(p, x, t, e, train=False), sched, lat, k,
        num_inference_steps=STEPS).features)(s["unet_vars"], latent, key)
    init, step_noises = _jax_noise(key, latent.features.shape, STEPS)
    pmean, _ = s["pvae"].encode(s["pst"])
    platent = pmean.with_features(torch.as_tensor(np.array(latent.features)))
    got = mp.diffusion.sample_latent(
        s["punet"], mp.diffusion.DDIMScheduler.create(), platent,
        num_inference_steps=STEPS, init_noise=init, step_noises=step_noises)
    _close(_np(got.features), ref)


def test_generate_end_to_end_matches_jax(setup):
    """build_generate_fn in both packages on the same input and noise:
    the same decoded voxel set.  The top-k decisions of every decoder
    level sit more than 1e-3 from their threshold, so float32 summation
    order cannot flip a row."""
    s = setup
    kw = dict(input_capacity=CAP, batch_size=B, resolution=RES,
              vae_scale=SCALE, sample_steps=STEPS)
    jfn = mt.serve.build_generate_fn(s["jvae"], s["junet"],
                                     md.DDIMScheduler.create(), **kw)
    key = jax.random.PRNGKey(11)
    ref_c, ref_v = jax.jit(jfn)(s["vae_vars"], s["unet_vars"]["params"],
                                jnp.asarray(s["cpad"]),
                                jnp.asarray(s["valid"]), key)
    pfn = mp.serve.build_generate_fn(s["pvae"], s["punet"],
                                     mp.diffusion.DDIMScheduler.create(),
                                     device="cpu", **kw)
    shape = (mp.serve.capacities(CAP)[0][2], UCH[0])
    init, step_noises = _jax_noise(key, shape, STEPS)
    coords, valid = pfn(s["cpad"], s["valid"], init_noise=init,
                        step_noises=step_noises)
    ref_c, ref_v = np.asarray(ref_c), np.asarray(ref_v)
    assert valid.sum() > 0
    np.testing.assert_array_equal(_np(valid), ref_v)
    np.testing.assert_array_equal(_np(coords), ref_c)

    # the margin of every top-k decision, on the port's own decode
    with torch.no_grad():
        pmean, _ = s["pvae"].encode(s["pst"])
        z = mp.diffusion.sample_latent(
            s["punet"], mp.diffusion.DDIMScheduler.create(),
            pmean.with_features(pmean.features * SCALE),
            num_inference_steps=STEPS, init_noise=init,
            step_noises=step_noises)
        out_clss, _, _ = s["pvae"].decode(
            z.with_features(z.features / SCALE), s["pst"].grid)
    caps = s["pvae"].decoder.level_capacities
    for lvl, lt in enumerate(out_clss):
        logits = lt.features[:, 0][lt.valid]
        k_max = caps[min(lvl + 1, 3)]
        thr = 0.0
        if int((logits > 0).sum()) > k_max:
            thr = max(float(torch.sort(logits, descending=True).values[
                k_max - 1]), 0.0)
        assert float((logits - thr).abs().min()) > 1e-3, lvl
