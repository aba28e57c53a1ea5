"""The port's VAE training path against the JAX package, on the CPU.

- The backward of ``FusedSparseConv`` (its plain dF and dW, which the CUDA
  kernels B2 and B3 replace on the card) against ``jax.grad`` of
  ``sparse_conv_apply`` over ``kernel_map``, on the four conv kinds, at
  rtol 1e-4, atol 1e-5 (float32; summation order only).
- BatchNorm in train mode (output, gradients, running statistics) and
  ``vae_loss``, at 1e-5.
- One full VAE train step at the tiny widths of `test_torch_generate.py`
  (weights from JAX through ``load_flax``, occupancy heads ×100 so that
  no top-k decision lies within float32 noise of its threshold, JAX's
  ``eps``): the loss, every gradient by name and the new running
  statistics against ``jax.value_and_grad`` of `examples/train_vae.py`'s
  ``loss_fn``, at 1e-4·max|ref| per tensor.
- One Adam step against ``optax.adam``, a checkpoint round trip, and the
  ``train.vae`` entry point with a resume.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import models as mm
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.ops import fused_conv
from mink_octtree_stablediffusion_tpu_torch.train import vae as train_vae
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (from_flax,
                                                                  load_flax)

torch.set_num_threads(1)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _tensors(rng, n, cap, cin, ext, bsz):
    """The same sparse tensor (random voxels, random features) in both."""
    coords = []
    for b in range(bsz):
        c = np.unique(rng.randint(0, ext, (n, 3)), axis=0)
        coords.append(np.concatenate([np.full((len(c), 1), b, np.int32), c],
                                     1))
    cpad, valid = mp.ops.pad_to_capacity(np.concatenate(coords), cap)
    feats = (rng.randn(cap, cin) * valid[:, None]).astype(np.float32)
    jst = jax.jit(lambda c, f, v: mt.sparse_tensor(
        c, f, capacity=cap, valid=v, batch_size=bsz, extent=(ext,) * 3))(
        jnp.asarray(cpad), jnp.asarray(feats), jnp.asarray(valid))
    pst = mp.sparse_tensor(_t(cpad), _t(feats), capacity=cap, valid=_t(valid),
                           batch_size=bsz, extent=(ext,) * 3)
    np.testing.assert_array_equal(_np(pst.grid.coords),
                                  np.asarray(jst.grid.coords))
    return jst, pst


CONV_KINDS = {
    # name: (cin, cout, kernel spec kwargs, geometry)
    "k3s1": (4, 8, dict(kernel_size=3), "same"),
    "k3s2": (5, 7, dict(kernel_size=3, stride=2), "down"),
    "k2s2_pinned_transpose": (5, 6, dict(kernel_size=2, stride=2,
                                         transpose=True), "up"),
    "k2s2_generative": (4, 6, dict(kernel_size=2, stride=2, transpose=True),
                        "grow"),
}


@pytest.mark.parametrize("name", list(CONV_KINDS))
def test_fused_conv_backward_matches_jax_grad(rng, monkeypatch, name):
    """dF and dW of the port's fused conv (its ``FusedSparseConv`` backward,
    not autograd of the plain forward) against jax.grad of the kernel-map
    conv."""
    cin, cout, kw, geom = CONV_KINDS[name]
    jst, pst = _tensors(rng, 300, 512, cin, 12, 2)
    spec, pspec = (mt.ops.KernelSpec(ndim=3, **kw),
                   mp.ops.KernelSpec(ndim=3, **kw))
    jin, pin, feats = jst.grid, pst.grid, jst.features
    if geom == "same":
        jout, pout = jin, pin
    elif geom == "down":
        jout = jax.jit(lambda g: mt.ops.stride_grid(g, 2, 512))(jin)
        pout = mp.ops.stride_grid(pin, 2, 512)
    else:
        jin = jax.jit(lambda g: mt.ops.stride_grid(g, 2, 256))(jst.grid)
        pin = mp.ops.stride_grid(pst.grid, 2, 256)
        feats = feats[:256] * jin.valid[:, None]
        if geom == "up":
            jout, pout = jst.grid, pst.grid
        else:
            offs = spec.absolute_offsets(jin.stride)
            jout = jax.jit(lambda g: mt.ops.expand_grid(
                g, offs, (1, 1, 1), 2048))(jin)
            pout = mp.ops.expand_grid(pin, offs, (1, 1, 1), 2048)
    np.testing.assert_array_equal(_np(pout.coords), np.asarray(jout.coords))
    kern = (rng.randn(spec.volume, cin, cout) * 0.1).astype(np.float32)
    gout = (rng.randn(jout.capacity, cout) *
            np.asarray(jout.valid)[:, None]).astype(np.float32)

    nbr = jax.jit(lambda a, b: mt.ops.kernel_map(a, b, spec))(jin, jout)
    dref = jax.jit(jax.grad(lambda f, k: jnp.vdot(
        mt.ops.sparse_conv_apply(f, k, nbr), gout), argnums=(0, 1)))(
        feats, jnp.asarray(kern))

    calls = []
    for fn in ("fused_conv_dfeatures", "fused_conv_dkernel"):
        orig = getattr(fused_conv, fn)
        monkeypatch.setattr(fused_conv, fn, lambda *a, _o=orig, _n=fn: (
            calls.append(_n), _o(*a))[1])
    f = _t(feats).requires_grad_()
    k = _t(kern).requires_grad_()
    out = mp.ops.fused_sparse_conv(f, k, pin, pout, pspec)
    (out * _t(gout)).sum().backward()
    assert calls == ["fused_conv_dfeatures", "fused_conv_dkernel"]
    np.testing.assert_allclose(_np(f.grad), np.asarray(dref[0]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(_np(k.grad), np.asarray(dref[1]), rtol=1e-4,
                               atol=1e-5)


def test_batchnorm_train_mode_matches_jax(rng):
    """Output, input/scale/bias gradients and the updated running
    statistics (biased variance, momentum 0.9 on the old value)."""
    c = 6
    jst, pst = _tensors(rng, 200, 512, c, 10, 2)
    scale = rng.rand(c).astype(np.float32) + 0.5
    bias = rng.randn(c).astype(np.float32)
    stats = {"mean": rng.randn(c).astype(np.float32),
             "var": rng.rand(c).astype(np.float32) + 0.5}
    gout = rng.randn(512, c).astype(np.float32)
    bn = mt.nn.BatchNorm()

    def jfwd(params, f):
        y, upd = bn.apply({"params": params, "batch_stats": stats},
                          jst.replace(features=f), train=True,
                          mutable=["batch_stats"])
        return jnp.vdot(y.features, gout), (y.features, upd["batch_stats"])

    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    (_, (ref, ref_stats)), (dp, df) = jax.jit(jax.value_and_grad(
        jfwd, argnums=(0, 1), has_aux=True))(params, jst.features)

    pbn = mp.nn.BatchNorm(c, device="cpu")
    pbn.load_state_dict({"weight": _t(scale), "bias": _t(bias),
                         "running_mean": _t(stats["mean"]),
                         "running_var": _t(stats["var"])})
    pbn.train()
    f = pst.features.clone().requires_grad_()
    y = pbn(pst.with_features(f))
    (y.features * _t(gout)).sum().backward()
    for got, want in ((y.features, ref), (f.grad, df),
                      (pbn.weight.grad, dp["scale"]),
                      (pbn.bias.grad, dp["bias"]),
                      (pbn.running_mean, ref_stats["mean"]),
                      (pbn.running_var, ref_stats["var"])):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    pbn.eval()  # eval mode reads the running statistics and moves nothing
    before = pbn.running_mean.clone()
    pbn(pst)
    assert torch.equal(pbn.running_mean, before)


def test_vae_loss_matches_jax(rng):
    levels = []
    for cap in (256, 512):
        jst, pst = _tensors(rng, 150, cap, 1, 10, 2)
        target = rng.rand(cap) < 0.4
        levels.append((jst, pst, target))
    jmean, pmean = _tensors(rng, 60, 128, 4, 6, 2)
    lv = (rng.randn(128, 4) * 0.3).astype(np.float32)
    jlv = jmean.replace(features=jnp.asarray(lv))
    plv = pmean.with_features(_t(lv))
    ref, ref_aux = mm.vae_loss([j for j, _, _ in levels],
                               [jnp.asarray(t) for _, _, t in levels],
                               jmean, jlv, 1e-2)
    got, aux = mp.models.vae_loss([p for _, p, _ in levels],
                                  [_t(t) for _, _, t in levels], pmean, plv,
                                  1e-2)
    for g, r in ((got, ref), (aux["bce"], ref_aux["bce"]),
                 (aux["kld"], ref_aux["kld"])):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)


RES, B, CAP = 128, 2, 4096
VCH, KLD = (8, 16, 32, 32, 4), 1e-6


def test_vae_train_step_matches_jax():
    """One train step of the port (``make_train_step`` over
    ``train.vae.build_loss_fn``) against ``jax.value_and_grad`` of the
    ``loss_fn`` of `examples/train_vae.py`."""
    enc_caps, dec_caps = mp.serve.capacities(CAP)
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=B,
                                 points_per_shape=1500)
    cpad, valid, feats, _ = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(B)], CAP)
    jvae = mm.VAE(channels=VCH, encoder_capacities=enc_caps,
                  decoder_capacities=dec_caps)

    def build(cpad, valid, feats):
        return mt.sparse_tensor(cpad, feats, capacity=CAP, batch_size=B,
                                valid=valid, extent=(RES,) * 3)

    def loss_fn(params, batch_stats, batch, rng):  # examples/train_vae.py
        st = build(*batch)
        (out_clss, targets, sout, mean, log_var, _), upd = jvae.apply(
            {"params": params, "batch_stats": batch_stats}, st, st.grid, rng,
            mutable=["batch_stats"])
        loss, aux = mm.vae_loss(out_clss, targets, mean, log_var, KLD)
        return loss, (aux, upd["batch_stats"])

    batch = tuple(jnp.asarray(a) for a in (cpad, valid, feats))
    k = jax.random.PRNGKey(0)
    st0 = jax.jit(build)(*batch)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 100.0 if str(p[-2].key).endswith("_cls") and
        str(p[-1].key) == "kernel" else x,
        jax.jit(jvae.init)(k, st0, st0.grid, k))
    rng = jax.random.PRNGKey(5)
    (loss, (aux, new_bs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"], batch, rng)
    # the reparameterisation noise the JAX VAE draws (`vae.py:160-162`)
    eps = jax.random.normal(jax.random.split(rng)[0], (enc_caps[2], VCH[4]))

    pvae = mp.models.VAE(channels=VCH, encoder_capacities=enc_caps,
                         decoder_capacities=dec_caps, device="cpu")
    load_flax(pvae, variables)
    state = mp.train.TrainState(pvae, mp.train.vae_optimizer(
        pvae.parameters()))
    step = mp.train.make_train_step(train_vae.build_loss_fn(
        input_capacity=CAP, batch_size=B, resolution=RES, kld_weight=KLD,
        device="cpu"))
    with mp.nn.record_routes() as routes:
        ploss, paux = step(state, (cpad, valid, feats), eps=_t(eps))
    assert state.step == 1 and pvae.training
    assert {r.branch for r in routes} == {"fused", "identity"}

    np.testing.assert_allclose(float(ploss), float(loss), rtol=1e-4)
    np.testing.assert_allclose(float(paux["bce"]), float(aux["bce"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(paux["kld"]), float(aux["kld"]),
                               rtol=1e-4)
    ref_grads = from_flax({"params": grads})
    params = dict(pvae.named_parameters())
    assert set(ref_grads) == set(params)
    for name, ref in ref_grads.items():
        ref = ref.numpy()
        got = params[name].grad
        assert got is not None, name
        np.testing.assert_allclose(_np(got), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=name)
    buffers = dict(pvae.named_buffers())
    ref_stats = from_flax({"batch_stats": new_bs})
    assert set(ref_stats) == set(buffers)
    for name, ref in ref_stats.items():
        ref = ref.numpy()
        np.testing.assert_allclose(_np(buffers[name]), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


def test_adam_step_matches_optax(rng):
    shapes = {"a": (3, 4), "b": (5,)}
    params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (rng.randn(*s) * 10.0 ** -i).astype(np.float32)
              for n, s in shapes.items()} for i in range(3)]
    tx = optax.adam(1e-3)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    opt_state = tx.init(jp)
    tp = {n: torch.nn.Parameter(_t(v)) for n, v in params.items()}
    opt = mp.train.vae_optimizer(list(tp.values()), 1e-3)
    for g in grads:
        upd, opt_state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in tp.items():
            p.grad = _t(g[n])
        opt.step()
        for n in shapes:
            np.testing.assert_allclose(_np(tp[n]), np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-7)


def _tiny_state(seed):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                torch.nn.BatchNorm1d(4))
    return mp.train.TrainState(model, mp.train.vae_optimizer(
        model.parameters(), 1e-2))


def test_checkpoint_round_trip_resumes(tmp_path):
    """save → restore resumes the parameters, the running statistics, the
    optimizer state and the step: the next step matches an uninterrupted
    run exactly."""
    x = torch.randn(8, 3, generator=torch.Generator().manual_seed(0))

    def loss_fn(model, batch):
        out = model(batch)
        return (out ** 2).mean(), {"m": out.mean()}

    step = mp.train.make_train_step(loss_fn)
    a = _tiny_state(0)
    step(a, x)
    step(a, x)
    ckpt = mp.train.CheckpointManager(str(tmp_path / "ck"))
    assert ckpt.latest_step() is None
    ckpt.save(a.step, a)
    assert ckpt.latest_step() == 2
    b = ckpt.restore(_tiny_state(1))
    assert b.step == 2
    for (na, ta), (nb, tb) in zip(a.module.state_dict().items(),
                                  b.module.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i in sa["state"]:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][key], sb["state"][i][key])
    step(a, x)
    step(b, x)
    for pa, pb in zip(a.module.parameters(), b.module.parameters()):
        assert torch.equal(pa, pb)


def test_batch_iterator_matches_jax():
    ds = mp.data.SyntheticShapes(resolution=16, num_samples=7,
                                 points_per_shape=50)
    jds = mt.data.SyntheticShapes(resolution=16, num_samples=7,
                                  points_per_shape=50)
    got = [[s["label"] for s in b] for b in mp.data.batch_iterator(
        ds, 3, np.random.RandomState(4))]
    ref = [[s["label"] for s in b] for b in mt.data.batch_iterator(
        jds, 3, np.random.RandomState(4))]
    assert got == ref and len(got) == 2


def test_train_vae_entry_point_runs_and_resumes(tmp_path, caplog):
    """`python -m ...train.vae` on the CPU at a tiny size: it trains,
    checkpoints at the step cap, and a second run resumes there."""
    argv = ["--device", "cpu", "--resolution", "32", "--input_capacity",
            "2048", "--vae_channel", "4", "8", "8", "8", "4",
            "--batch_size", "2", "--ckpt_dir", str(tmp_path / "ck")]
    caplog.set_level("INFO", logger="train_vae")
    assert train_vae.main(argv + ["--steps", "2"]) == 0
    ckpt = mp.train.CheckpointManager(str(tmp_path / "ck"))
    assert ckpt.latest_step() == 2
    assert train_vae.main(argv + ["--steps", "3"]) == 0
    assert ckpt.latest_step() == 3
    assert "resumed at step 2" in caplog.text
    done = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("done")]
    assert len(done) == 2 and "nan" not in " ".join(done)
