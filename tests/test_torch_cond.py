"""The port's conditioning and template-free canvas generation against JAX.

- Cross-attention (`SparseTransformer(cross_attention_dim)`) on the cases
  of `tests/test_attention.py::test_cross_attention_uses_conditioning` and
  `tests/test_clip_dims.py` (CLIP's [77, 768] and [257, 1024]), within
  1e-5.
- The canvas configuration of `scripts/cond_control.py` at tiny widths
  (`serve.generation_models` with every generation flag, resolution 128,
  batch 2): a UNet forward with cross-attention at [77, 768],
  ``cond_into_time`` and ``attn_window``, where the stride-8 level takes
  the window path and the stride-16 level full attention, within
  1e-4·max|ref|; the two cases of `tests/test_cond_into_time.py` on it
  (the projection gets a gradient and the condition moves the output; a
  zero condition gives, bit for bit, the output of a zeroed projection).
- The slice as a whole: DDIM with CFG (guidance 3.0) samples from noise on
  a zero canvas template, and the pruning decoder prunes the canvas;
  JAX's draws are handed to the port.  The latent within 1e-4·max|ref|,
  the decoded voxel sets equal.

The port initialises the weights; the flax variables are filled from them
through `utils.convert`'s own name map (the tree's shapes from
``jax.eval_shape``, so JAX compiles no ``init``), and ``load_flax`` then
checks that the cover is one to one.  float32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import diffusion as md
from mink_octtree_stablediffusion_tpu import models as mm
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.utils import convert
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (from_flax,
                                                                  load_flax)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
RES, B, CAP, STEPS, SCALE, GUIDANCE = 128, 2, 4096, 2, 0.1428, 3.0
VCH, UCH, GROUP, S, D = (8, 16, 32, 32, 4), (4, 8, 16, 16), 4, 77, 768
CELLS = (RES // 8) ** 3  # the stride-8 canvas of one instance
MAX_KEEP = 128  # keeps every decoder level's growth inside its buffer


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _tensor(rng, b=2, cap=64, c=8, res=16, stride=1, n=24):
    vox = [np.unique(rng.randint(0, res, (n, 3)), axis=0) * stride
           for _ in range(b)]
    coords = mt.ops.batched_coordinates_np(vox)
    cpad, vpad = mt.ops.pad_to_capacity(coords, cap)
    feats = (rng.randn(cap, c) * vpad[:, None]).astype(np.float32)
    kw = dict(capacity=cap, batch_size=b, stride=stride,
              extent=(res * stride,) * 3)
    jst = jax.jit(lambda co, f, v: mt.sparse_tensor(co, f, valid=v, **kw))(
        jnp.asarray(cpad), jnp.asarray(feats), jnp.asarray(vpad))
    pst = mp.sparse_tensor(_t(cpad), _t(feats), valid=_t(vpad), **kw)
    np.testing.assert_array_equal(_np(pst.grid.coords),
                                  np.asarray(jst.grid.coords))
    return jst, pst


@pytest.mark.parametrize("s,d,scale", [(5, 16, 1.0), (77, 768, 0.05),
                                       (257, 1024, 0.05)])
def test_cross_attention_matches_jax(s, d, scale):
    """Queries are the packed rows (padded to max_len, masked after the
    attention), keys and values the condition, all attended."""
    rng = np.random.RandomState(0)
    jst, pst = _tensor(rng)
    jm = mt.nn.SparseTransformer(max_len=64, cross_attention_dim=d)
    ehs = (rng.randn(2, s, d) * scale).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jst, encoder_hidden_state=ehs)
    assert v["params"]["SparseAttention_0"]["to_kv"]["kernel"].shape == \
        (d, 16)
    pm = mp.nn.SparseTransformer(8, max_len=64, cross_attention_dim=d,
                                 device="cpu")
    load_flax(pm, v)
    outs = []
    for e in (ehs, ehs * 2.0):
        ref = jax.jit(lambda v, x, e: jm.apply(v, x, encoder_hidden_state=e)
                      .features)(v, jst, jnp.asarray(e))
        with mp.nn.attention.record_attention() as routes:
            got = _np(pm(pst, _t(e)).features)
        assert routes == [mp.nn.attention.AttentionRoute("cross", 64, 8, s)]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)
        outs.append(got)
    assert np.abs(outs[0] - outs[1]).max() > 1e-5  # the condition counts
    with pytest.raises(ValueError, match="encoder_hidden_state"):
        pm(pst)


def _jax_noise(key, shape, steps):
    """`sample_latent`'s draws: r0 → initial noise, then one split per
    step (`diffusion/module.py:154-172`)."""
    r0, key = jax.random.split(key)
    init = jax.random.normal(r0, shape)
    step_noises = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        step_noises.append(_t(jax.random.normal(sub, shape)))
    return _t(init), step_noises


def _flax_from_port(shapes, module):
    """The flax variables of ``shapes`` (a tree of ``ShapeDtypeStruct``)
    holding ``module``'s parameters, through `utils.convert`'s name map (a
    Dense kernel is the transpose of its Linear weight)."""
    sd = {k: v.detach().numpy() for k, v in module.state_dict().items()}

    def leaf(path, x):
        keys = tuple(str(k.key) for k in path)
        name, _ = convert._translate(keys[0], keys[1:], np.zeros(x.shape))
        a = sd[name]
        return jnp.asarray(a.T if keys[-1] == "kernel" and a.ndim == 2
                           else a)
    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    load_flax(module, variables)  # the cover is one to one
    return variables


@pytest.fixture(scope="module")
def models():
    """`serve.generation_models` with every generation flag, the decoder's
    occupancy heads scaled ×100 so that no top-k decision lies within
    1e-3 of its threshold, and every attention's query projection scaled
    ×0.1; the same configuration in JAX, its variables filled from the
    port's weights; one jitted JAX UNet forward.

    The query scale keeps the softmax well conditioned.  Unscaled, this
    random 4-channel UNet's attention logits reach ~170 at the canvas
    level, where the float32 rounding of every upstream layer (~1e-5 of
    each value) moves the outputs by up to 2.5e-4 of max|out|: against
    the same forward in float64, the port's float32 output was 2.2e-4 off
    and JAX's 9.1e-5.  Scaled, both are within 1e-5 of float64."""
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=B,
                                 points_per_shape=1500)
    cpad, valid, _, _ = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(B)], CAP)
    pvae, punet = mp.serve.generation_models(
        input_capacity=CAP, batch_size=B, vae_channel=VCH, unet_channel=UCH,
        group=GROUP, attn_max_len=512, attn_window=64, with_cross_attn=True,
        cross_attention_dim=D, cond_into_time=True, with_window_attn=True,
        latent_canvas=True, resolution=RES, max_keep=MAX_KEEP, device="cpu",
        seed=4)
    enc_caps, dec_caps = mp.serve.capacities(CAP)
    assert pvae.decoder_capacities == (B * CELLS,) + dec_caps[1:]
    assert punet.down_capacities == (B * CELLS // 8, B * CELLS // 64,
                                     B * CELLS // 512)
    with torch.no_grad():
        for lvl in range(1, 5):
            getattr(pvae.decoder, f"block{lvl}_cls").kernel.mul_(100.0)
        for mod in punet.modules():
            if isinstance(mod, mp.nn.SparseAttention):
                mod.to_q.weight.mul_(0.1)
    jvae = mm.VAE(channels=VCH, encoder_capacities=enc_caps,
                  decoder_capacities=pvae.decoder_capacities,
                  max_keep=MAX_KEEP, with_window_attn=True,
                  latent_canvas=True)
    junet = mm.UNet(channels=UCH, group=GROUP, attn_max_len=512,
                    attn_window=64, with_cross_attn=True,
                    cross_attention_dim=D, cond_into_time=True,
                    down_capacities=punet.down_capacities)
    feats = jnp.ones((CAP, 1)) * jnp.asarray(valid)[:, None]
    st = jax.jit(lambda c, v: mt.sparse_tensor(
        c, feats, capacity=CAP, batch_size=B, valid=v,
        extent=(RES,) * 3))(jnp.asarray(cpad), jnp.asarray(valid))
    k = jax.random.PRNGKey(0)
    jtemplate = mt.SparseTensor(
        grid=mt.ops.canvas_grid(B, (RES,) * 3, (8,) * 3),
        features=jnp.zeros((B * CELLS, UCH[0])))
    rng = np.random.RandomState(2)
    ehs = (rng.randn(B, S, D) * 0.5).astype(np.float32)
    vae_vars = _flax_from_port(jax.eval_shape(jvae.init, k, st, st.grid, k),
                               pvae)
    unet_vars = _flax_from_port(jax.eval_shape(
        junet.init, k, jtemplate, jnp.zeros((B,), jnp.int32),
        jnp.asarray(ehs)), punet)
    pst = mp.sparse_tensor(_t(cpad), torch.ones(CAP, 1) *
                           _t(valid)[:, None], capacity=CAP, batch_size=B,
                           valid=_t(valid), extent=(RES,) * 3)
    jfwd = jax.jit(lambda p, f, t, e: junet.apply(
        p, jtemplate.replace(features=f), t, e, train=False).features)
    return dict(st=st, pst=pst, jvae=jvae, junet=junet, pvae=pvae,
                punet=punet, vae_vars=vae_vars, unet_vars=unet_vars,
                jtemplate=jtemplate, ehs=ehs, jfwd=jfwd)


def _canvas_input(seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(B * CELLS, UCH[0]).astype(np.float32)
    canvas = mp.ops.canvas_grid(B, RES, 8, device="cpu")
    return x, mp.SparseTensor(grid=canvas, features=_t(x)), np.array(
        [700, 20], np.int32)


def test_unet_every_flag_matches_jax(models):
    """One forward on the canvas: the stride-8 level (4,096 cells an
    instance > attn_max_len 512) takes the window path, the stride-16
    level (512) full attention, and every attention group cross-attends;
    the flax tree carried over with no leaf left over."""
    m = models
    sd = from_flax(m["unet_vars"], m["punet"])
    assert set(sd) == set(m["punet"].state_dict())
    x, px, t = _canvas_input()
    ref = m["jfwd"](m["unet_vars"], x, t, m["ehs"])
    with torch.no_grad(), mp.nn.attention.record_attention() as routes:
        got = m["punet"](px, _t(t), _t(m["ehs"]))
    kinds = {(r.kind, r.rows) for r in routes}
    assert {("window", B * CELLS), ("full", B * CELLS // 8),
            ("cross", B * CELLS), ("cross", B * CELLS // 8)} <= kinds, kinds
    _close(_np(got.features), ref)


def test_cond_into_time_grad_and_sensitivity(models):
    """`tests/test_cond_into_time.py`'s first case: the pooled projection
    is bias-free and gets a gradient, and the condition moves the output
    (×3), in step with JAX's."""
    m = models
    punet = m["punet"]
    assert set(m["unet_vars"]["params"]["cond_time_proj"]) == {"kernel"}
    assert punet.cond_time_proj.bias is None
    x, px, t = _canvas_input(4)
    outs = []
    for scale in (1.0, 3.0):
        ehs = m["ehs"] * scale
        ref = np.asarray(m["jfwd"](m["unet_vars"], x, t, ehs))
        punet.zero_grad()
        out = punet(px, _t(t), _t(ehs)).features
        (out ** 2).mean().backward()
        grad = punet.cond_time_proj.weight.grad
        assert grad is not None and float(grad.square().sum()) > 0
        _close(_np(out), ref)
        outs.append(ref)
    punet.zero_grad()
    assert np.abs(outs[0] - outs[1]).max() > 1e-3


def test_zero_condition_leaves_temb_untouched(models):
    """`tests/test_cond_into_time.py`'s second case, CFG's unconditional
    branch: a zero condition adds exactly zero to temb, so the output
    equals, bit for bit, the output with the projection zeroed; and it
    matches JAX's."""
    m = models
    punet = m["punet"]
    x, px, t = _canvas_input(5)
    ehs0 = np.zeros_like(m["ehs"])
    ref = m["jfwd"](m["unet_vars"], x, t, ehs0)
    w = punet.cond_time_proj.weight.detach().clone()
    with torch.no_grad():
        out = _np(punet(px, _t(t), _t(ehs0)).features)
        try:
            punet.cond_time_proj.weight.zero_()
            out_z = _np(punet(px, _t(t), _t(ehs0)).features)
        finally:  # the fixture's UNet is shared
            punet.cond_time_proj.weight.copy_(w)
    np.testing.assert_array_equal(out, out_z)
    _close(out, ref)


def test_conditioned_canvas_generation_matches_jax(models):
    """Template-free sampling as `scripts/e2e_generalize.py` composes it:
    ``canvas_grid``, DDIM with CFG from noise on a zero canvas template,
    then the pruning decode.  The sampled latent within 1e-4·max|ref|,
    the voxel sets equal, every top-k decision more than 1e-3 from its
    threshold, every instance decoded."""
    m = models
    jvae, junet = m["jvae"], m["junet"]
    bn = {"params": m["vae_vars"]["params"],
          "batch_stats": m["vae_vars"]["batch_stats"]}
    sched = md.DDIMScheduler.create()
    key = jax.random.PRNGKey(5)
    ehs = jnp.asarray(m["ehs"])

    @jax.jit
    def jgen(p, v, key):
        z = md.sample_latent(
            lambda x, t, e: junet.apply(p, x, t, e, train=False), sched,
            m["jtemplate"], key, num_inference_steps=STEPS,
            encoder_hidden_state=ehs, guidance_scale=GUIDANCE)
        z = z.with_features(z.features / SCALE)
        _, _, sout = jvae.apply(v, z, m["st"].grid, train=False,
                                method=jvae.decode)
        return z.features, sout.grid.coords, sout.grid.valid

    ref_z, ref_c, ref_v = jgen(m["unet_vars"], bn, key)
    init, step_noises = _jax_noise(key, (B * CELLS, UCH[0]), STEPS)
    canvas = mp.ops.canvas_grid(B, RES, 8, device="cpu")
    template = mp.SparseTensor(grid=canvas,
                               features=torch.zeros(B * CELLS, UCH[0]))
    with torch.no_grad():
        z = mp.diffusion.sample_latent(
            m["punet"], mp.diffusion.DDIMScheduler.create(), template,
            num_inference_steps=STEPS, encoder_hidden_state=_t(ehs),
            guidance_scale=GUIDANCE, init_noise=init,
            step_noises=step_noises)
        z = z.with_features(z.features / SCALE)
        out_clss, _, sout = m["pvae"].decode(z, m["pst"].grid)
    _close(_np(z.features), ref_z)
    ref_c, ref_v = np.asarray(ref_c), np.asarray(ref_v)
    assert ref_v.sum() > 0
    assert len(np.unique(ref_c[ref_v][:, 0])) == B  # every instance decodes
    np.testing.assert_array_equal(_np(sout.grid.valid), ref_v)
    np.testing.assert_array_equal(_np(sout.grid.coords), ref_c)
    # `top_k_mask` keeps logit > max(k-th, 0): the k-th itself is dropped,
    # so every other logit must lie more than 1e-3 from the threshold
    for lvl, lt in enumerate(out_clss):
        logits = lt.features[:, 0][lt.valid]
        thr = 0.0
        if int((logits > 0).sum()) > MAX_KEEP:
            thr = float(torch.sort(logits, descending=True).values[
                MAX_KEEP - 1])
        gap = (logits - thr).abs()
        assert int((gap == 0).sum()) <= 1, lvl
        assert float(gap[gap > 0].min()) > 1e-3, lvl


def test_generation_flags_are_ported():
    """No generation flag raises any more, and neither does ``remat``
    (training), whose UNet holds the same parameters."""
    plain = mp.models.UNet(channels=(4, 8, 8, 8), device="cpu")
    remat = mp.models.UNet(channels=(4, 8, 8, 8), remat=True, device="cpu")
    assert remat.remat and {n: p.shape for n, p in plain.named_parameters()
                            } == {n: p.shape for n, p in
                                  remat.named_parameters()}
    unet = mp.models.UNet(channels=(4, 8, 8, 8), with_cross_attn=True,
                          cross_attention_dim=16, cond_into_time=True,
                          attn_window=8, device="cpu")
    assert unet.block1_0.block1.cross_attention is not None
    assert unet.block3_0.block1.cross_attention is None  # no attention
