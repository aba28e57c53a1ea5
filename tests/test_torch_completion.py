"""The port's generative reconstruction and completion networks and the
reconstruction entry point against the JAX package, on the CPU, float32.

Weights: random flax variables carried into the port by ``utils.convert``;
the same numpy inputs.  Exact: ``_prune_level`` (membership targets and
the kept voxels, with ties at the k-th score, in train and eval mode), the
seed tensor, every level's grid and membership target and the decoded
voxel set.  Logits and BatchNorm statistics within 1e-4·max|ref|; one
``GenerativeNet`` train step's loss (`examples/reconstruction.py`'s
per-level BCE) within 1e-5 relative and every gradient within
1e-4·max|ref| of that tensor's ``jax.value_and_grad``.  The two
optimizers against optax; then ``train.reconstruction`` for 2 steps with
``--device cpu``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import models as mm
from mink_octtree_stablediffusion_tpu.models import completion as jcomp
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.models import completion as pcomp
from mink_octtree_stablediffusion_tpu_torch.train import reconstruction as tr
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (from_flax,
                                                                  load_flax)

torch.set_num_threads(1)
REL = 1e-4
RES, B, CAP = 16, 2, 512
GEN = dict(channels=(8, 8, 8, 4, 4, 4, 4),
           level_capacities=tr.level_capacities(B, CAP))
COMP = dict(enc_channels=(4, 4, 8, 8, 8, 8), dec_channels=(8, 8, 4, 4, 4, 4),
            enc_capacities=(512, 256, 128, 64, 32, 16),
            dec_capacities=(64, 128, 256, 512, 512))


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=REL * max(np.abs(ref).max(), 1e-30),
                               err_msg=err_msg)


def _random_variables(abstract, rng):
    def draw(path, x):
        key = str(path[-1].key)
        std = 0.3
        if key == "kernel":
            std = (np.sqrt(2.0 / (x.shape[0] * x.shape[1])) if len(x.shape)
                   == 3 else 1.0 / np.sqrt(x.shape[0]))
        a = rng.randn(*x.shape).astype(np.float32) * std
        if key == "var":
            a = np.abs(a) + 0.5
        return jnp.asarray(a)
    return jax.tree_util.tree_map_with_path(draw, abstract)


def _carry(jmod, pmod, rng, *args):
    abstract = jax.eval_shape(
        lambda *a: jmod.init(jax.random.PRNGKey(0), *a), *args)
    variables = _random_variables(abstract, rng)
    load_flax(pmod, variables)
    return variables


def _shapes(first=0):
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=4,
                                 points_per_shape=1024)
    samples = [ds[first + i] for i in range(B)]
    cpad, valid, _, _ = mp.data.collate_pointclouds(
        [s["coords"] for s in samples], CAP)
    return cpad, valid, np.array([s["label"] for s in samples], np.int32)


def _jax_inputs(cpad, valid, labels):
    """`examples/reconstruction.py`'s ``seed_tensor`` and ``target_grid``."""
    ext = (max(RES, 64),) * 3
    coords = jnp.concatenate([jnp.arange(B, dtype=jnp.int32)[:, None],
                              jnp.zeros((B, 3), jnp.int32)], axis=-1)
    grid = mt.SparseGrid(coords=coords, valid=jnp.ones((B,), bool),
                         stride=(64,) * 3, batch_size=B, extent=ext)
    z = mt.SparseTensor(grid=grid, features=jax.nn.one_hot(labels, 4) * 10.0)
    tg = mt.sparse_tensor(cpad, jnp.ones((CAP, 1)) * valid[:, None],
                          capacity=CAP, batch_size=B, valid=valid,
                          extent=ext).grid
    return z, tg


def _port_inputs(cpad, valid, labels):
    return (tr.seed_tensor(labels, n_classes=4, resolution=RES,
                           device="cpu"),
            tr.target_grid(cpad, valid, batch_size=B, resolution=RES,
                           device="cpu"))


def _same_grid(pg, jg):
    np.testing.assert_array_equal(_np(pg.coords), np.asarray(jg.coords))
    np.testing.assert_array_equal(_np(pg.valid), np.asarray(jg.valid))
    assert pg.stride == tuple(jg.stride)


def test_seed_tensor_matches_example():
    cpad, valid, labels = _shapes()
    jz, jtg = jax.jit(_jax_inputs)(cpad, valid, labels)
    pz, ptg = _port_inputs(cpad, valid, labels)
    _same_grid(pz.grid, jz.grid)
    np.testing.assert_array_equal(_np(pz.features), np.asarray(jz.features))
    _same_grid(ptg, jtg)


@pytest.mark.parametrize("train", [True, False])
def test_prune_level_matches_jax(rng, train):
    """Positive scores above the level's buffer, a run of ties at the k-th
    score (dropped), and invalid rows; ``| target`` only in training."""
    cpad, valid, _ = _shapes()
    ext = (RES,) * 3
    jst = jax.jit(lambda c, v: mt.sparse_tensor(
        c, jnp.ones((CAP, 3)) * v[:, None], capacity=CAP, batch_size=B,
        valid=v, extent=ext))(cpad, valid)
    pst = mp.sparse_tensor(_t(cpad), _t(valid)[:, None].float() *
                           torch.ones(CAP, 3), capacity=CAP, batch_size=B,
                           valid=_t(valid), extent=ext)
    _same_grid(pst.grid, jst.grid)
    scores = rng.randn(CAP).astype(np.float32)
    scores[10:40] = 2.5  # ties straddling the k-th score
    scores[[3, 5]] = scores.max() + 1
    target_pts = cpad[::3].copy()
    tvalid = valid[::3].copy()
    jtg = jax.jit(lambda c, v: mt.sparse_tensor(
        c, jnp.ones((len(c), 1)), capacity=len(c), batch_size=B, valid=v,
        extent=ext).grid)(target_pts, tvalid)
    ptg = mp.sparse_tensor(_t(target_pts), torch.ones(len(target_pts), 1),
                           capacity=len(target_pts), batch_size=B,
                           valid=_t(tvalid), extent=ext).grid
    cap = 32
    jout, jtarget = jax.jit(
        lambda o, l, g: jcomp._prune_level(o, l, g, cap, train))(
        jst, jst.replace(features=jnp.asarray(scores)[:, None]), jtg)
    pout, ptarget = pcomp._prune_level(
        pst, pst.with_features(_t(scores)[:, None]), ptg, cap, train)
    np.testing.assert_array_equal(_np(ptarget), np.asarray(jtarget))
    _same_grid(pout.grid, jout.grid)
    np.testing.assert_array_equal(_np(pout.features),
                                  np.asarray(jout.features))
    if train:  # every target voxel is kept
        assert bool((pout.valid.sum() >= ptarget.sum()).item())
    else:  # the ties at the k-th score are dropped
        assert 0 < int(pout.valid.sum()) < cap


@pytest.mark.parametrize("train", [True, False])
def test_generative_net_matches_jax(rng, train):
    cpad, valid, labels = _shapes()
    jz, jtg = jax.jit(_jax_inputs)(cpad, valid, labels)
    pz, ptg = _port_inputs(cpad, valid, labels)
    jnet = mm.GenerativeNet(**GEN)
    pnet = mp.models.GenerativeNet(4, **GEN, device="cpu")
    variables = _carry(jnet, pnet, rng, jz, jtg)
    (jcls, jtargets, jout), upd = jax.jit(lambda v, z, g: jnet.apply(
        v, z, g, train=train, mutable=["batch_stats"]))(variables, jz, jtg)
    pnet.train(train)
    with torch.no_grad():
        pcls, ptargets, pout = pnet(pz, ptg)
    for lvl, (pl, jl, pt, jt) in enumerate(zip(pcls, jcls, ptargets,
                                               jtargets)):
        _same_grid(pl.grid, jl.grid)
        _close(pl.features, jl.features, err_msg=f"level {lvl}")
        np.testing.assert_array_equal(_np(pt), np.asarray(jt))
    _same_grid(pout.grid, jout.grid)
    if train:  # the targets are force-kept (in eval these weights keep none)
        assert int(pout.valid.sum()) > 0
        buffers = dict(pnet.named_buffers())
        for name, want in from_flax({"batch_stats": upd["batch_stats"]}
                                    ).items():
            _close(buffers[name], want.numpy(), err_msg=name)


@pytest.mark.parametrize("train", [True, False])
def test_completion_net_matches_jax(rng, train):
    cpad, valid, _ = _shapes(first=1)
    ext = (RES,) * 3
    jst = jax.jit(lambda c, v: mt.sparse_tensor(
        c, jnp.ones((CAP, 1)) * v[:, None], capacity=CAP, batch_size=B,
        valid=v, extent=ext))(cpad, valid)
    pst = mp.sparse_tensor(_t(cpad), _t(valid)[:, None].float(),
                           capacity=CAP, batch_size=B, valid=_t(valid),
                           extent=ext)
    jnet = mm.CompletionNet(**COMP)
    pnet = mp.models.CompletionNet(1, **COMP, device="cpu")
    variables = _carry(jnet, pnet, rng, jst, jst.grid)
    (jcls, jtargets, jout), upd = jax.jit(lambda v, x: jnet.apply(
        v, x, x.grid, train=train, mutable=["batch_stats"]))(variables, jst)
    pnet.train(train)
    with torch.no_grad():
        pcls, ptargets, pout = pnet(pst, pst.grid)
    for lvl, (pl, jl, pt, jt) in enumerate(zip(pcls, jcls, ptargets,
                                               jtargets)):
        _same_grid(pl.grid, jl.grid)
        _close(pl.features, jl.features, err_msg=f"level {lvl}")
        np.testing.assert_array_equal(_np(pt), np.asarray(jt))
    _same_grid(pout.grid, jout.grid)
    buffers = dict(pnet.named_buffers())
    for name, want in from_flax({"batch_stats": upd["batch_stats"]}).items():
        _close(buffers[name], want.numpy(), err_msg=name)


def test_generative_net_step_matches_jax(rng):
    cpad, valid, labels = _shapes(first=2)
    jz, jtg = jax.jit(_jax_inputs)(cpad, valid, labels)
    jnet = mm.GenerativeNet(**GEN)
    pnet = mp.models.GenerativeNet(4, **GEN, device="cpu")
    variables = _carry(jnet, pnet, rng, jz, jtg)

    def loss_fn(params, batch_stats):  # examples/reconstruction.py
        (out_clss, targets, _), upd = jnet.apply(
            {"params": params, "batch_stats": batch_stats}, jz, jtg,
            mutable=["batch_stats"])
        bce = 0.0
        for logits_t, target in zip(out_clss, targets):
            lo = logits_t.features[:, 0]
            v = logits_t.valid
            t = target.astype(lo.dtype)
            per = jnp.maximum(lo, 0.) - lo * t + jnp.log1p(
                jnp.exp(-jnp.abs(lo)))
            bce += jnp.sum(jnp.where(v, per, 0.)) / jnp.maximum(
                jnp.sum(v.astype(lo.dtype)), 1.)
        return bce / len(out_clss), upd["batch_stats"]

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"])
    pnet.train()
    ploss, aux = tr.build_loss_fn(n_classes=4, batch_size=B, resolution=RES,
                                  device="cpu")(pnet, (cpad, valid, labels))
    ploss.backward()
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=1e-5)
    assert int(aux["final_voxels"]) > 0
    named = dict(pnet.named_parameters())
    ref_grads = from_flax({"params": grads})
    assert set(ref_grads) == set(named)
    for name, ref in ref_grads.items():
        _close(named[name].grad, ref.numpy(), err_msg=name)
    buffers = dict(pnet.named_buffers())
    for name, want in from_flax({"batch_stats": new_bs}).items():
        _close(buffers[name], want.numpy(), err_msg=name)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_reconstruction_optimizers_match_optax(rng, opt):
    """``optax.sgd(lr, momentum=0.9)``, and ``optax.chain(
    clip_by_global_norm(1.0), adam(lr))``: 3 updates, one clipped."""
    import optax
    lr = 1e-2
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) * s for s in (0.1, 3.0, 0.2)]
    tx = (optax.sgd(lr, momentum=0.9) if opt == "sgd" else
          optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr)))
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    param = torch.nn.Parameter(_t(p0))
    popt = tr.make_optimizer([param], opt, lr)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        param.grad = _t(g)
        popt.step()
        # float32: torch's Adam orders the bias corrections otherwise
        np.testing.assert_allclose(_np(param), np.asarray(jp), rtol=1e-5,
                                   atol=1e-6)


def test_train_reconstruction_entry_point(capsys):
    out = tr.main(["--device", "cpu", "--resolution", "16", "--batch_size",
                   "2", "--input_capacity", "1024", "--num_points", "512",
                   "--steps", "2"])
    assert np.isfinite(out["final_bce"])
    assert 0.0 <= out["generation_iou"] <= 1.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        out
