"""The port's pooling layers, geometry heads, classic ResNet/SE blocks and
ResNet classifiers against the JAX package, on the CPU, and the
``multigpu_dp`` entry point.

Weights: random flax variables (shapes from ``jax.eval_shape`` of
``init``, no compile) loaded into the port through ``utils.convert``
(``load_flax``: one-to-one cover and shapes checked).  Float32, the same
numpy inputs; the layers at 1e-5, convs, blocks and one train step at
2e-5 (of the whole gradient's max|ref| for the train step's gradients).

- ``ops.pool.local_pool_apply`` (sum, avg, max) on a map with missing
  neighbours, a row without any, and planted ties for max (JAX splits a
  tied max's gradient evenly, as ``amax`` does): output and gradient.
- ``LocalPool``, ``PoolTranspose``, ``GlobalPool``, ``GlobalMaxAvgPool``
  and ``broadcast_concat``: output and input gradient.
- ``ResNetStack``'s geometry heads (``avg_pool``, ``pool_transpose``,
  ``upsample_interpolate``, and ``use_conv=False`` with and without a
  down head, the latter given an ``out_grid`` it must not pin), train mode: output
  grid, features and running statistics.
- ``ResBasicBlock``, ``ResBottleneck``, ``SELayer``, ``SEBasicBlock``,
  ``SEBottleneck``.
- ResNet14 and a bottleneck ResNet at narrow widths: logits, and one train
  step's loss, gradients and running statistics against
  ``jax.value_and_grad`` of `examples/multigpu_dp.py`'s loss.
- ``multigpu_dp.main`` (``python -m ...multigpu_dp``) with ``--nproc 2
  --backend gloo --device cpu``: 2 steps over two gloo ranks (which must
  agree bit for bit) and the checkpoint that every rank restores.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import models as mm
from mink_octtree_stablediffusion_tpu.nn import blocks as jblocks
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch import multigpu_dp
from mink_octtree_stablediffusion_tpu_torch.nn import blocks as pblocks
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (from_flax,
                                                                  load_flax)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=2e-5, atol=2e-5)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _tensors(rng, cap=512, cin=6, ext=12, bsz=2, n=250):
    """The same sparse tensor in both packages."""
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


def _random_variables(abstract, rng, fan_in=False):
    """Random parameters and running statistics shaped like ``abstract``
    (variances positive): N(0, 0.3²), or with ``fan_in`` the kernels at
    their initialisers' scale (kaiming over K·Cin, LeCun over the input),
    so that a deep network's activations keep their size."""
    def draw(path, x):
        std = 0.3
        if fan_in and str(path[-1].key) == "kernel":
            std = (np.sqrt(2.0 / (x.shape[0] * x.shape[1])) if len(x.shape)
                   == 3 else 1.0 / np.sqrt(x.shape[0]))
        a = rng.randn(*x.shape).astype(np.float32) * std
        if str(path[-1].key) == "var":
            a = np.abs(a) + 0.5
        return jnp.asarray(a)
    return jax.tree_util.tree_map_with_path(draw, abstract)


def _carry(jmod, pmod, rng, *args, fan_in=False, **kw):
    """Random flax variables for ``jmod`` (``init`` on ``args``), loaded
    into ``pmod``."""
    abstract = jax.eval_shape(
        lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **kw), *args)
    variables = _random_variables(abstract, rng, fan_in)
    load_flax(pmod, variables)
    return variables


def _input_grad(pfn, pst, gout):
    f = pst.features.clone().requires_grad_()
    out = pfn(pst.with_features(f))
    feats = out if isinstance(out, torch.Tensor) else out.features
    (feats * _t(gout)).sum().backward()
    return out, f.grad


# -- local_pool_apply ---------------------------------------------------------

@pytest.mark.parametrize("mode", ["sum", "avg", "max"])
def test_local_pool_apply_matches_jax(rng, mode):
    n_in, n_out, k, c = 40, 30, 8, 5
    # few distinct values: many ties for max; all-negative rows too
    feats = (rng.randint(-3, 3, (n_in, c)) * 0.5).astype(np.float32)
    nbr = rng.randint(0, n_in, (k, n_out)).astype(np.int32)
    nbr[rng.rand(k, n_out) < 0.4] = -1
    nbr[:, 3] = -1  # a row without any neighbour
    nbr[:, 4] = nbr[0, 4]  # every offset the same row: a K-way tie
    gout = rng.randn(n_out, c).astype(np.float32)

    def jfn(f):
        out, num = mt.ops.local_pool_apply(f, jnp.asarray(nbr), mode)
        return jnp.vdot(out, gout), (out, num)
    (_, (ref, rnum)), rgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(feats))
    f = _t(feats).requires_grad_()
    out, num = mp.ops.local_pool_apply(f, _t(nbr), mode)
    (out * _t(gout)).sum().backward()
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(_np(num), np.asarray(rnum))
    np.testing.assert_allclose(_np(f.grad), np.asarray(rgrad), **TOL)
    assert np.all(_np(out)[3] == 0)


# -- pooling layers -----------------------------------------------------------

def _pool_case(name, jst, pst):
    """(JAX fn of a features array, port fn of a SparseTensor)."""
    if name.startswith("local"):
        kw = {"local_avg_k2s2": dict(kernel_size=2, stride=2, mode="avg",
                                     out_capacity=256),
              "local_max_k2s2": dict(kernel_size=2, stride=2, mode="max",
                                     out_capacity=256),
              "local_sum_k3s1": dict(kernel_size=3, stride=1, mode="sum")}[
            name]
        jl, pl = mt.nn.LocalPool(**kw), mp.nn.LocalPool(**kw)
        return (lambda f: jl.apply({}, jst.replace(features=f)).features,
                lambda x: pl(x))
    if name == "pool_transpose":
        jc = jax.jit(lambda g: mt.ops.stride_grid(g, 2, 256))(jst.grid)
        pc = mp.ops.stride_grid(pst.grid, 2, 256)
        jl, pl = mt.nn.PoolTranspose(), mp.nn.PoolTranspose()
        # the coarse features are the fine rows' first 256, masked
        return (lambda f: jl.apply({}, mt.SparseTensor(
                    grid=jc, features=f[:256] * jc.valid[:, None]),
                    jst.grid).features,
                lambda x: pl(mp.SparseTensor(
                    grid=pc, features=x.features[:256] *
                    pc.valid[:, None]), pst.grid))
    if name == "global_max_avg":
        return (lambda f: mt.nn.GlobalMaxAvgPool().apply(
                    {}, jst.replace(features=f)),
                lambda x: mp.nn.GlobalMaxAvgPool()(x))
    if name == "global_sum":
        return (lambda f: mt.nn.pool.global_pool_features(
                    jst.replace(features=f), "sum"),
                lambda x: mp.nn.GlobalPool("sum")(x))
    vec = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    return (lambda f: mt.nn.pool.broadcast_concat(
                jst.replace(features=f), jnp.asarray(vec)).features,
            lambda x: mp.nn.broadcast_concat(x, _t(vec)))


@pytest.mark.parametrize("name", ["local_avg_k2s2", "local_max_k2s2",
                                  "local_sum_k3s1", "pool_transpose",
                                  "global_max_avg", "global_sum",
                                  "broadcast_concat"])
def test_pool_layers_match_jax(rng, name):
    jst, pst = _tensors(rng)
    jfn, pfn = _pool_case(name, jst, pst)
    ref = jax.jit(jfn)(jst.features)
    gout = rng.randn(*ref.shape).astype(np.float32)
    rgrad = jax.jit(jax.grad(lambda f: jnp.vdot(jfn(f), gout)))(jst.features)
    out, grad = _input_grad(pfn, pst, gout)
    feats = out if isinstance(out, torch.Tensor) else out.features
    np.testing.assert_allclose(_np(feats), np.asarray(ref), **TOL)
    np.testing.assert_allclose(_np(grad), np.asarray(rgrad), **TOL)


# -- ResNetStack's geometry heads --------------------------------------------

@pytest.mark.parametrize("after,use_conv", [
    ("avg_pool", True), ("pool_transpose", True),
    ("upsample_interpolate", True), ("downsample", False), (None, False)])
def test_resnet_stack_geometry_heads_match_jax(rng, after, use_conv):
    jst, pst = _tensors(rng, cin=4)
    out_grid = (None, None)
    if after is None:
        # a non-conv adapt head takes no pin: another grid must be ignored
        jo, po = _tensors(rng, cin=4)
        out_grid = (jo.grid, po.grid)
    if after in ("pool_transpose", "upsample_interpolate"):
        # from stride 2: back onto the input grid, or grown to stride 1
        jx = jax.jit(lambda g: mt.ops.stride_grid(g, 2, 256))(jst.grid)
        px = mp.ops.stride_grid(pst.grid, 2, 256)
        f = jst.features[:256] * jx.valid[:, None]
        jin = mt.SparseTensor(grid=jx, features=f)
        pin = mp.SparseTensor(grid=px, features=_t(f))
        if after == "pool_transpose":
            out_grid = (jst.grid, pst.grid)
    else:
        jin, pin = jst, pst
    cap = 1024 if after == "upsample_interpolate" else 256
    jstack = jblocks.ResNetStack(8, layers=2, after=after, use_conv=use_conv,
                                 out_capacity=cap)
    pstack = pblocks.ResNetStack(4, 8, layers=2, after=after,
                                 use_conv=use_conv, out_capacity=cap,
                                 device="cpu")
    variables = _carry(jstack, pstack, rng, jin, None, out_grid[0])
    ref, upd = jax.jit(lambda v, x, g: jstack.apply(
        v, x, None, g, mutable=["batch_stats"]))(variables, jin, out_grid[0])
    pstack.train()
    got = pstack(pin, out_grid=out_grid[1])
    np.testing.assert_array_equal(_np(got.grid.coords),
                                  np.asarray(ref.grid.coords))
    assert got.grid.stride == tuple(ref.grid.stride)
    np.testing.assert_allclose(_np(got.features), np.asarray(ref.features),
                               **CONV_TOL)
    buffers = dict(pstack.named_buffers())
    for name, want in from_flax({"batch_stats": upd["batch_stats"]}).items():
        np.testing.assert_allclose(_np(buffers[name]), want.numpy(),
                                   **CONV_TOL, err_msg=name)


# -- classic blocks -----------------------------------------------------------

BLOCKS = {  # name: (JAX module, port module, uses train mode)
    "res_basic_s2": (lambda: jblocks.ResBasicBlock(8, stride=2,
                                                   out_capacity=256),
                     lambda: pblocks.ResBasicBlock(6, 8, stride=2,
                                                   out_capacity=256,
                                                   device="cpu"), True),
    "res_bottleneck": (lambda: jblocks.ResBottleneck(4),
                       lambda: pblocks.ResBottleneck(6, 4, device="cpu"),
                       True),
    "se_layer": (lambda: jblocks.SELayer(reduction=2),
                 lambda: pblocks.SELayer(6, 2, device="cpu"), False),
    "se_basic": (lambda: jblocks.SEBasicBlock(6, reduction=2),
                 lambda: pblocks.SEBasicBlock(6, 6, reduction=2,
                                              device="cpu"), True),
    "se_bottleneck_s2": (lambda: jblocks.SEBottleneck(
                             4, stride=2, reduction=4, out_capacity=256),
                         lambda: pblocks.SEBottleneck(
                             6, 4, stride=2, reduction=4, out_capacity=256,
                             device="cpu"), True),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_blocks_match_jax(rng, name):
    jst, pst = _tensors(rng)
    jmk, pmk, train = BLOCKS[name]
    jmod, pmod = jmk(), pmk()
    kw = {"train": True} if train else {}
    variables = _carry(jmod, pmod, rng, jst, **kw)
    fn = jax.jit(lambda v, x: jmod.apply(v, x, mutable=["batch_stats"],
                                         **kw))
    ref, upd = fn(variables, jst)
    gout = rng.randn(*ref.features.shape).astype(np.float32)
    rgrad = jax.jit(jax.grad(lambda f: jnp.vdot(fn(
        variables, jst.replace(features=f))[0].features, gout)))(
        jst.features)
    pmod.train()
    out, grad = _input_grad(pmod, pst, gout)
    np.testing.assert_array_equal(_np(out.grid.coords),
                                  np.asarray(ref.grid.coords))
    np.testing.assert_allclose(_np(out.features), np.asarray(ref.features),
                               **CONV_TOL)
    np.testing.assert_allclose(_np(grad), np.asarray(rgrad), **CONV_TOL)


# -- ResNet classifiers -------------------------------------------------------

# resolution 64: at 16 the stages at stride >= 16 hold one voxel an
# instance, and a BatchNorm over those two rows turns float32 rounding into
# gradient differences of several percent, in either package
RES, B, CAP = 64, 2, 4096
NARROW = dict(out_channels=4, planes=(4, 8, 8, 8), init_dim=4,
              input_capacity=CAP)


class _Bottleneck14(mp.models.ResNetBase):
    block = pblocks.ResBottleneck
    layers = (1, 1, 1, 1)


@pytest.mark.parametrize("kind", ["resnet14", "bottleneck"])
def test_resnet_step_matches_jax(rng, kind):
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=4,
                                 points_per_shape=512)
    samples = [ds[i] for i in (1, 2)]
    cpad, valid, feats, _ = mp.data.collate_pointclouds(
        [s["coords"] for s in samples], CAP)
    labels = np.array([s["label"] for s in samples], np.int32)
    if kind == "resnet14":
        jnet = mm.ResNet14(**NARROW)
        pnet = mp.models.ResNet14(**NARROW, device="cpu")
    else:
        jnet = mm.resnet.ResNetBase(block=jblocks.ResBottleneck,
                                    layers=(1, 1, 1, 1), **NARROW)
        pnet = _Bottleneck14(**NARROW, device="cpu")

    def build(cpad, valid, feats):
        return mt.sparse_tensor(cpad, feats, capacity=CAP, batch_size=B,
                                valid=valid, extent=(RES,) * 3)

    batch = tuple(jnp.asarray(a) for a in (cpad, valid, feats))
    variables = _carry(jnet, pnet, rng, jax.eval_shape(build, *batch),
                       fan_in=True)

    def loss_fn(params, batch_stats):  # examples/multigpu_dp.py
        logits, upd = jnet.apply(
            {"params": params, "batch_stats": batch_stats}, build(*batch),
            mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()
        return loss, (logits, upd["batch_stats"])

    (loss, (logits, new_bs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"])
    pnet.train()
    st = mp.sparse_tensor(_t(cpad), _t(feats), capacity=CAP, batch_size=B,
                          valid=_t(valid), extent=(RES,) * 3)
    plogits = pnet(st)
    ploss = F.cross_entropy(plogits, _t(labels).long())
    ploss.backward()
    np.testing.assert_allclose(_np(plogits), np.asarray(logits), **CONV_TOL)
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=2e-5)
    named = dict(pnet.named_parameters())
    ref_grads = {n: g.numpy() for n, g in from_flax({"params": grads}).items()}
    assert set(ref_grads) == set(named)
    # of the whole gradient's max: the norms' bias gradients are sums whose
    # terms largely cancel, so float32 reassociation moves them by ~1e-3 of
    # their own size
    top = max(np.abs(r).max() for r in ref_grads.values())
    for name, ref in ref_grads.items():
        np.testing.assert_allclose(_np(named[name].grad), ref, rtol=0,
                                   atol=2e-5 * top, err_msg=name)
    buffers = dict(pnet.named_buffers())
    for name, ref in from_flax({"batch_stats": new_bs}).items():
        np.testing.assert_allclose(_np(buffers[name]), ref.numpy(),
                                   **CONV_TOL, err_msg=name)


# -- the multigpu_dp entry point ---------------------------------------------

def test_multigpu_dp_entry_point_runs_and_restores(tmp_path, capfd):
    """2 steps on two gloo ranks, whose replicas agree bit for bit; the
    checkpoint that every rank restores holds those replicas (the same
    digest once loaded here)."""
    ckpt = str(tmp_path / "ck")
    argv = ["--nproc", "2", "--backend", "gloo", "--device", "cpu",
            "--ckpt_dir", ckpt, "--steps", "2"]
    assert multigpu_dp.main(argv) == 0
    log = capfd.readouterr().err  # the spawned ranks' logs
    assert "resumed at step 0" in log
    assert "(2 devices, global batch 4)" in log
    assert "step 0 loss" in log and "step 1 loss" in log
    digest = re.search(r"2 ranks agree: (\w+)", log).group(1)
    assert os.listdir(ckpt) == ["step_00000002.pt"]
    cfg = multigpu_dp.parse_args(argv)
    net = mp.models.ResNet14(out_channels=4, input_capacity=cfg.capacity,
                             device="cpu")
    state = mp.train.CheckpointManager(ckpt).restore(mp.train.TrainState(
        net, mp.train.vae_optimizer(net.parameters(), cfg.lr)))
    assert state.step == 2
    assert multigpu_dp.replica_digest(net).startswith(digest)
