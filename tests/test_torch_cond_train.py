"""Training of the canvas and conditioned models in the port against the JAX
package, on the CPU, and the three new entry points.

One tiny step of each new loss, from the same weights, batch and draws
(JAX's reparameterisation, canvas, timestep and noise draws handed to the
port), against ``jax.value_and_grad`` of the scripts' own loss functions,
at resolution 32 (a 64-cell canvas an instance), batch 2, on
`ProceduralShapes`: the loss within 1e-4 relative, every gradient
(after the optimizer's global-norm clipping, which scales them all
alike) within 1e-4·max|ref|: of its own tensor for the VAE; for the
diffusion steps, of the whole gradient, with each tensor's relative RMS
within ``GRAD_RTOL_MEDIAN`` at the median and ``GRAD_RTOL_MAX`` at the
worst, as `test_torch_diffusion_train.py` holds its step.

- the canvas VAE of `scripts/e2e_generalize.py` phase 1 (``vae_loss_fn``,
  ``latent_canvas``, occupancy heads ×100 so that no top-k decision lies
  within float32 noise of its threshold), with its running statistics;
- canvas diffusion of phase 2 (``diff_loss_fn``: ``encode_canvas`` and
  the UNet with ``remat`` on both sides), for the ``sample`` and
  ``v_prediction`` targets, stepped by Adafactor as ``--diff_opt
  adafactor`` does; `utils.convert` carries the remat UNet's flax tree
  with nothing new (``_check_grads`` holds its names one to one);
- conditioned canvas diffusion of `scripts/cond_control.py` (a learned
  class table, cross-attention, ``cond_into_time``, the ``sample``
  target) with a given drop mask: the dropped instance's table row, and
  the rows of classes not in the batch, get a zero gradient.

Every attention's ``to_q`` is scaled ×0.1, as in `test_torch_cond.py`.
Then ``train.generalize``, ``train.cond`` and ``train.diffusion_cross`` run
two steps each with ``--device cpu`` at tiny widths, write checkpoints,
and a second run restores them.
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
from mink_octtree_stablediffusion_tpu_torch.train import (cond,
                                                          diffusion_cross,
                                                          generalize)
from mink_octtree_stablediffusion_tpu_torch.train import vae as train_vae
from mink_octtree_stablediffusion_tpu_torch.utils import convert
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (from_flax,
                                                                  load_flax)

torch.set_num_threads(1)

RES, B, CAP, PTS, SCALE = 32, 2, 1024, 400, 0.1428
VCH, UCH, GROUP, D, S = (4, 8, 8, 8, 4), (4, 8, 8, 8), 4, 16, 4
CELLS = (RES // 8) ** 3


def _t(a):
    return torch.as_tensor(np.array(a))


def _batch():
    ds = mp.data.ProceduralShapes(resolution=RES, num_samples=B,
                                  points_per_shape=PTS, seed=0)
    return generalize.collate([ds[i] for i in range(B)], CAP)


def _jvae():
    enc, dec = mp.serve.capacities(CAP)
    dec = (max(dec[0], B * CELLS),) + dec[1:]
    return mm.VAE(channels=VCH, encoder_capacities=enc,
                  decoder_capacities=dec, latent_canvas=True,
                  canvas_noise_std=1.0), enc


def _build(cpad, valid, feats):
    return mt.sparse_tensor(cpad, feats, capacity=CAP, batch_size=B,
                            valid=valid, extent=(RES,) * 3)


def _flax_from_port(abstract, module):
    """A flax variables tree shaped like ``abstract`` (``jax.eval_shape``
    of ``init``) holding ``module``'s weights, through ``utils.convert``'s
    name map."""
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


# The relative RMS, port vs JAX, of the diffusion steps' gradients: at the
# median tensor and at the worst (float32 on both sides, the sums in
# another order; the worst are attention projections and the class table,
# sums over many rows whose terms largely cancel).  A layout or routing
# fault moves a gradient by a relative RMS of order one.
GRAD_RTOL_MEDIAN, GRAD_RTOL_MAX = 1e-4, 5e-3


def _check_grads(model, grads, clip, per_tensor=False):
    """Every parameter's gradient against JAX's, scaled as the optimizer's
    clipping at ``clip`` scales it: each element within 1e-4·max|ref| (of
    its own tensor with ``per_tensor``, else of the whole tree), and the
    diffusion steps' relative RMS within the bounds above."""
    norm = float(jnp.sqrt(sum(jnp.sum(g ** 2)
                              for g in jax.tree.leaves(grads))))
    scale = clip / norm if norm >= clip else 1.0
    ref_grads = {n: g.numpy() * scale
                 for n, g in from_flax({"params": grads}).items()}
    named = dict(model.named_parameters())
    assert set(ref_grads) == set(named)
    top = max(np.abs(r).max() for r in ref_grads.values())
    rel = {}
    for name, ref in ref_grads.items():
        got = named[name].grad
        assert got is not None, name
        got = got.numpy()
        bound = np.abs(ref).max() if per_tensor else top
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * bound,
                                   err_msg=name)
        rel[name] = float(np.linalg.norm(got - ref) /
                          max(np.linalg.norm(ref), 1e-30))
    if not per_tensor:
        worst = max(rel, key=rel.get)
        assert rel[worst] <= GRAD_RTOL_MAX, (worst, rel[worst])
        assert float(np.median(list(rel.values()))) <= GRAD_RTOL_MEDIAN
    return named


def test_canvas_vae_step_matches_jax():
    """Phase 1's step: ``vae_loss_fn`` of `scripts/e2e_generalize.py`."""
    cpad, valid, feats, _ = _batch()
    jvae, enc = _jvae()

    def loss_fn(params, batch_stats, batch, rng):
        st = _build(*batch)
        (out_clss, targets, _, mean, log_var, _), upd = jvae.apply(
            {"params": params, "batch_stats": batch_stats}, st, st.grid, rng,
            mutable=["batch_stats"])
        loss, aux = mm.vae_loss(out_clss, targets, mean, log_var, 1e-6)
        return loss, (aux, upd["batch_stats"])

    batch = tuple(jnp.asarray(a) for a in (cpad, valid, feats))
    k = jax.random.PRNGKey(0)
    st0 = jax.jit(_build)(*batch)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 100.0 if str(p[-2].key).endswith("_cls") and
        str(p[-1].key) == "kernel" else x,
        jax.jit(jvae.init)(k, st0, st0.grid, k))
    rng = jax.random.PRNGKey(5)
    (loss, (aux, new_bs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"], batch, rng)
    # the VAE's draws (`models/vae.py:160-166`, `ops/canvas.py:63`)
    r_eps, r_canvas = jax.random.split(rng)
    eps = jax.random.normal(r_eps, (enc[2], VCH[4]))
    canvas_noise = jax.random.normal(r_canvas, (B * CELLS, VCH[4]))

    pvae = generalize.canvas_vae(vae_channel=VCH, input_capacity=CAP,
                                 batch_size=B, resolution=RES, device="cpu")
    assert pvae.decoder_capacities[0] == B * CELLS
    load_flax(pvae, variables)
    state = mp.train.TrainState(pvae, mp.train.canvas_vae_optimizer(
        pvae.parameters(), 1e-3, 10))
    step = mp.train.make_train_step(train_vae.build_loss_fn(
        input_capacity=CAP, batch_size=B, resolution=RES, kld_weight=1e-6,
        device="cpu"))
    ploss, paux = step(state, (cpad, valid, feats), eps=_t(eps),
                       canvas_noise=_t(canvas_noise))
    np.testing.assert_allclose(float(ploss), float(loss), rtol=1e-4)
    for key in ("bce", "kld"):
        np.testing.assert_allclose(float(paux[key]), float(aux[key]),
                                   rtol=1e-4)
    _check_grads(pvae, grads, 1.0, per_tensor=True)
    buffers = dict(pvae.named_buffers())
    for name, ref in from_flax({"batch_stats": new_bs}).items():
        ref = ref.numpy()
        np.testing.assert_allclose(buffers[name].numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


def _diffusion_models(**unet_kw):
    """The port's frozen canvas VAE and canvas UNet, the JAX UNet of the
    same configuration, and the JAX canvas latent of ``_batch()``."""
    batch = _batch()
    pvae = generalize.canvas_vae(vae_channel=VCH, input_capacity=CAP,
                                 batch_size=B, resolution=RES, device="cpu",
                                 seed=3)
    punet = generalize.canvas_unet(unet_channel=UCH, batch_size=B,
                                   resolution=RES, group=GROUP, device="cpu",
                                   seed=4, **unet_kw)
    # as `test_torch_cond.py`: unscaled, this random UNet's attention
    # logits are large enough that float32 rounding alone (in either
    # package) moves its gradients by ~1e-3 of their size
    with torch.no_grad():
        for mod in punet.modules():
            if isinstance(mod, mp.nn.SparseAttention):
                mod.to_q.weight.mul_(0.1)
    jvae, _ = _jvae()
    junet = mm.UNet(channels=UCH, group=GROUP, attn_max_len=128,
                    down_capacities=punet.down_capacities, **unet_kw)
    k = jax.random.PRNGKey(0)
    jb = tuple(jnp.asarray(a) for a in batch[:3])
    st0 = jax.jit(_build)(*jb)
    vv = _flax_from_port(jax.eval_shape(jvae.init, k, st0, st0.grid, k),
                         pvae)

    @jax.jit
    def encode_canvas(vv, st):  # scripts/e2e_generalize.py:337-344
        mean, _ = jvae.apply(vv, st, method=jvae.encode)
        mean = mean.with_features(
            jax.lax.stop_gradient(mean.features * SCALE))
        canvas = mt.ops.canvas_grid(B, mean.grid.extent, mean.grid.stride)
        return mt.ops.expand_to_canvas(mean, canvas)
    return batch, pvae, punet, junet, encode_canvas(vv, st0)


@pytest.fixture(scope="module")
def canvas_step():
    """JAX's side of phase 2's step (``diff_loss_fn``) for both targets,
    from one trace of the UNet with ``remat=True``: its output and VJP
    once, then ``jax.value_and_grad`` of the script's
    ``diffusion_training_loss`` in that output for each target, pulled
    back through the VJP (the chain rule of ``jax.value_and_grad`` of the
    whole loss; the noised input does not depend on the parameters)."""
    batch, pvae, punet, junet, lat = _diffusion_models(remat=True)
    k = jax.random.PRNGKey(0)
    uv = _flax_from_port(jax.eval_shape(
        junet.init, k, lat, jnp.zeros((B,), jnp.int32)), punet)
    rng = jax.random.PRNGKey(7)
    r_t, r_n = jax.random.split(rng)  # `diffusion/module.py:112-116`
    t = jax.random.randint(r_t, (B,), 0, 1000)
    noise = jax.random.normal(r_n, lat.features.shape)

    @jax.jit
    def ref(params, lat):
        sched = md.DDPMScheduler.create()
        noised = md.add_noise_per_instance(sched, lat, t, noise)
        out, pull = jax.vjp(lambda p: junet.apply(
            {"params": p}, noised, t, None).features, params)
        res = {}
        for pt in ("sample", "v_prediction"):
            (loss, _), ct = jax.value_and_grad(
                lambda o: md.diffusion_training_loss(
                    lambda x, tt, e: lat.replace(features=o),
                    md.DDPMScheduler.create(prediction_type=pt), lat, rng,
                    nll_params=None, resolution=RES, prediction_type=pt),
                has_aux=True)(out)
            res[pt] = (loss, {"unet": pull(ct)[0]})
        return res
    return batch, pvae, punet, t, noise, ref(uv["params"], lat)


@pytest.mark.parametrize("prediction_type", ["sample", "v_prediction"])
def test_canvas_diffusion_step_matches_jax(canvas_step, prediction_type):
    """Phase 2's step with ``--remat --diff_opt adafactor`` (the JAX UNet
    with ``remat=True``)."""
    batch, pvae, punet, t, noise, ref = canvas_step
    loss, grads = ref[prediction_type]
    punet.zero_grad(set_to_none=True)
    model = torch.nn.ModuleDict({"unet": punet})
    state = mp.train.TrainState(model, mp.train.adafactor_diffusion_optimizer(
        model.parameters(), 2e-4, 100, 10))
    before = {n: p.clone() for n, p in model.named_parameters()}
    step = mp.train.make_train_step(generalize.build_diffusion_loss_fn(
        pvae, mp.diffusion.DDPMScheduler.create(
            prediction_type=prediction_type),
        input_capacity=CAP, batch_size=B, resolution=RES, vae_scale=SCALE,
        prediction_type=prediction_type, device="cpu"))
    with mp.nn.record_routes() as routes:
        ploss, _ = step(state, batch, timesteps=_t(t), noise=_t(noise))
    assert any(r.recompute for r in routes)
    assert all(p.grad is None for p in pvae.parameters())
    np.testing.assert_allclose(float(ploss), float(loss), rtol=1e-4)
    _check_grads(model, grads, 0.5)
    with torch.no_grad():  # the next case starts from the same weights
        for n, p in model.named_parameters():
            p.copy_(before[n])


def test_cond_diffusion_step_matches_jax():
    """`scripts/cond_control.py`'s step with a learned table and a given
    drop mask: instance 0 (class 1) dropped, instance 1 (class 2) kept."""
    batch, pvae, punet, junet, lat = _diffusion_models(
        with_cross_attn=True, cross_attention_dim=D, cond_into_time=True)
    labels, drop = np.array([1, 2], np.int32), np.array([True, False])
    batch = batch[:3] + (labels,)
    table0 = cond.class_table(4, S, D)
    sched = md.DDPMScheduler.create(prediction_type="sample")
    k = jax.random.PRNGKey(0)
    uv = _flax_from_port(jax.eval_shape(
        junet.init, k, lat, jnp.zeros((B,), jnp.int32),
        jnp.asarray(table0[:B])), punet)

    def loss_fn(params, latent, labels, drop, rng):
        ehs = params["cond_table"][labels]
        ehs = jnp.where(drop[:, None, None], 0.0, ehs)
        return md.diffusion_training_loss(
            lambda x, t, e: junet.apply({"params": params["unet"]}, x, t, e),
            sched, latent, rng, nll_params=None, resolution=RES,
            prediction_type="sample", encoder_hidden_state=ehs)

    params = {"unet": uv["params"], "cond_table": jnp.asarray(table0)}
    rng = jax.random.PRNGKey(9)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, lat, jnp.asarray(labels), jnp.asarray(drop), rng)
    r_t, r_n = jax.random.split(rng)
    t = jax.random.randint(r_t, (B,), 0, sched.num_train_timesteps)
    noise = jax.random.normal(r_n, lat.features.shape)

    model = torch.nn.ModuleDict({"unet": punet})
    model.register_parameter("cond_table", torch.nn.Parameter(_t(table0)))
    load_flax(model, {"params": params})
    state = mp.train.TrainState(model, mp.train.diffusion_optimizer(
        model.parameters(), 2e-4, 100, 10))
    step = mp.train.make_train_step(generalize.build_diffusion_loss_fn(
        pvae, mp.diffusion.DDPMScheduler.create(prediction_type="sample"),
        input_capacity=CAP, batch_size=B, resolution=RES, vae_scale=SCALE,
        prediction_type="sample", device="cpu", cond_dropout=0.1))
    ploss, _ = step(state, batch, timesteps=_t(t), noise=_t(noise),
                    drop=_t(drop))
    np.testing.assert_allclose(float(ploss), float(loss), rtol=1e-4)
    named = _check_grads(model, grads, 0.5)
    g = named["cond_table"].grad
    assert float(g[2].abs().max()) > 0
    assert torch.all(g[[0, 1, 3]] == 0)
    assert named["unet.cond_time_proj.weight"].grad.abs().max() > 0


def test_canvas_entry_points_run_and_restore(tmp_path, caplog):
    """``train.generalize`` (both phases), ``train.cond`` (on the VAE
    that ``train.generalize`` wrote) and ``train.diffusion_cross``: two
    steps each on the CPU, a checkpoint, and a run that restores it."""
    caplog.set_level("INFO")
    d = str(tmp_path / "ck")
    tiny = ["--device", "cpu", "--resolution", "32", "--points", "400",
            "--input_capacity", "1024", "--batch_size", "2",
            "--vae_channel", *map(str, VCH), "--unet_channel",
            *map(str, UCH), "--group", "4", "--ckpt_dir", d]
    # phase 3 at 2 samples of 2 DDPM steps: its path runs whole, at a
    # fraction of the script's default 16 samples of 50 steps
    gen = tiny + ["--train_shapes", "4", "--val_shapes", "2", "--steps_vae",
                  "2", "--steps_diff", "2", "--eval_every", "2",
                  "--sample_steps", "2", "--gen_samples", "2"]
    out = generalize.main(gen + ["--diff_opt", "adafactor", "--remat",
                                 "--attn_window", "8", "--attn_max_len",
                                 "32", "--level0_skip"])
    assert out["steps_vae"] == 2 and out["steps_diff"] == 2
    assert np.isfinite(out["diff_loss_last"])
    assert 0.0 <= out["val_recon_iou"] <= 1.0
    vae_ck = mp.train.CheckpointManager(f"{d}/vae")
    diff_ck = mp.train.CheckpointManager(f"{d}/diff_sample")
    assert vae_ck.latest_step() == 2 and diff_ck.latest_step() == 2
    out2 = generalize.main(gen + ["--skip_vae", "--steps_diff", "3",
                                  "--diff_opt", "adafactor", "--remat",
                                  "--attn_window", "8", "--attn_max_len",
                                  "32", "--level0_skip"])
    assert out2["steps_vae"] == 2 and out2["steps_diff"] == 3
    assert "restored VAE at step 2" in caplog.text
    # --stream_device: phase 1 on batches synthesized on the device
    out3 = generalize.main(tiny + [
        "--train_shapes", "4", "--val_shapes", "2", "--steps_vae", "1",
        "--steps_diff", "0", "--stream_device", "--ckpt_dir",
        str(tmp_path / "stream")])
    assert out3["stream_device"] and out3["stream"]
    assert out3["steps_vae"] == 1 and 0.0 <= out3["val_recon_iou"] <= 1.0

    # the oracle and the per-class scoring at their smallest: 2 classifier
    # steps, 4 held-out shapes, one CFG scale, one round of 2 DDPM steps
    oracle = ["--val_shapes", "2", "--steps_cls", "2", "--cls_points", "64",
              "--oracle_shapes", "4", "--cfg_scales", "3", "--rounds", "1",
              "--sample_steps", "2"]
    out = cond.main(tiny + oracle + ["--train_shapes", "4", "--steps_diff",
                                     "2", "--cross_attention_dim", str(D),
                                     "--cond_into_time"])
    assert out["steps_diff"] == 2 and np.isfinite(out["diff_loss_last"])
    payload = torch.load(f"{d}/diff_cond/step_00000002.pt",
                         weights_only=True)
    assert payload["model"]["cond_table"].shape == (4, S, D)
    out = cond.main(tiny + oracle + ["--train_shapes", "4", "--steps_diff",
                                     "2", "--cross_attention_dim", str(D),
                                     "--cond_into_time", "--skip_diff"])
    assert out["steps_diff"] == 2

    dc = ["--device", "cpu", "--ckpt_dir", str(tmp_path / "dc"),
          "--cross_attention_dim", "32"]
    assert diffusion_cross.main(dc + ["--steps", "2"]) == 0
    assert diffusion_cross.main(dc + ["--steps", "3"]) == 0
    assert "resumed at step 2" in caplog.text
    assert mp.train.CheckpointManager(str(tmp_path / "dc")).latest_step() \
        == 3
    for mode in ("clip-text", "clip-image"):
        with pytest.raises(NotImplementedError, match="CLIP"):
            diffusion_cross.main(dc + ["--cond", mode])


def test_text_encoder_matches_jax_example():
    """The ``random`` table: the example's per-caption RandomState draw, in
    this process."""
    import importlib
    ex = importlib.import_module("examples.diffusion_cross")
    caps = ["a picture of a box", "a picture of a torus",
            "a picture of a box"]
    ref = np.asarray(ex.TextEncoder("random", dim=32)(caps))
    got = diffusion_cross.TextEncoder("random", dim=32, device="cpu")(caps)
    assert got.shape == (3, 77, 32)
    np.testing.assert_array_equal(got.numpy(), ref)
