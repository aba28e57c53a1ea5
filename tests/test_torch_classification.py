"""The port's ModelNet40 classifiers, PointNet and the classification entry
point against the JAX package, on the CPU, float32.

Weights: random flax variables (shapes from ``jax.eval_shape`` of
``init``) carried into the port by ``utils.convert``; the same numpy
inputs (eight `SyntheticShapes` collated by the entry point's
``collate``).
Exact: ``collate_fields`` and ``field_slice``.  Logits and BatchNorm
statistics within 1e-4·max|ref|; one train step's loss within 1e-5
relative and every gradient within 1e-4·max|ref| of that tensor's
``jax.value_and_grad`` (`examples/classification_modelnet40.py`'s loss;
the splat variant's within 6e-4 of that tensor's max, see there).

- ``PointNet`` (dense) and ``MinkowskiPointNet``: train mode (logits and
  the flax BatchNorm's running statistics, momentum 0.99 and the biased
  variance) and eval mode.
- ``MinkowskiFCNN`` and ``MinkowskiSplatFCNN`` at narrow widths: one
  train step (logits, statistics, loss, gradients), and eval mode.
- Dropout only with a generator, only in ``.train()``.
- ``train.classification`` for 2 steps with ``--device cpu``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import models as mm
from mink_octtree_stablediffusion_tpu.data import collate as jcollate
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.train import classification as tc
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (from_flax,
                                                                  load_flax)

torch.set_num_threads(1)
REL = 1e-4
# 8 shapes: the dense heads' BatchNorm over 2 instances is ill-conditioned
# (float32 JAX alone is 5e-4·max away from a float64 evaluation there)
RES, B, PTS, VOXEL = 32, 8, 48, 0.05
CAP = B * PTS
EXTENT = tc.field_extent(VOXEL)
NARROW = dict(embedding_channel=16, channels=(4, 6, 8, 8, 8),
              voxel_capacity=CAP)


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


def _batch(first=0):
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=B + 2,
                                 points_per_shape=PTS)
    return tc.collate([ds[first + i] for i in range(B)], resolution=RES,
                      num_points=PTS, voxel_size=VOXEL, capacity=CAP)


def _fields(batch):
    cpad, valid, fpad, _ = batch
    jf = mt.TensorField(coordinates=jnp.asarray(cpad),
                        features=jnp.asarray(fpad), valid=jnp.asarray(valid),
                        batch_size=B, extent=EXTENT)
    pf = tc.build_field(cpad, valid, fpad, batch_size=B, extent=EXTENT,
                        device="cpu")
    return jf, pf


def test_collate_fields_matches_jax(rng):
    coords = [rng.rand(n, 3).astype(np.float32) * 9 for n in (5, 7, 4)]
    feats = [rng.randn(len(c), 2).astype(np.float32) for c in coords]
    for cap in (20, 12):  # room to spare, and a cut
        for got, ref in zip(mp.data.collate_fields(coords, feats, cap),
                            jcollate.collate_fields(coords, feats, cap)):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("stride", [1, 4])
def test_field_slice_matches_jax(rng, stride):
    """Each point reads its voxel at the tensor's stride; points whose
    voxel is missing (a cut buffer) read zeros."""
    jf, pf = _fields(_batch())
    cap = 64 if stride == 4 else CAP
    jst, _ = jax.jit(lambda f: f.sparse(capacity=cap, stride=stride))(jf)
    pst, _ = pf.sparse(capacity=cap, stride=stride)
    np.testing.assert_array_equal(_np(pst.grid.coords),
                                  np.asarray(jst.grid.coords))
    feats = rng.randn(cap, 5).astype(np.float32)
    ref = jax.jit(lambda t, f: mm.field_slice(t, f))(
        jst.replace(features=jnp.asarray(feats)), jf)
    got = mp.models.field_slice(pst.with_features(_t(feats)), pf)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


def _pointnet(kind):
    if kind == "dense":
        x = np.random.RandomState(4).randn(B, 40, 3).astype(np.float32)
        return (mm.PointNet(out_channel=4, embedding_channel=16),
                mp.models.PointNet(4, 16, device="cpu"), jnp.asarray(x),
                _t(x))
    jf, pf = _fields(_batch())
    return (mm.MinkowskiPointNet(out_channel=4, embedding_channel=16),
            mp.models.MinkowskiPointNet(4, 16, device="cpu"), jf, pf)


@pytest.mark.parametrize("kind", ["dense", "minkowski"])
def test_pointnet_matches_jax(rng, kind):
    jnet, pnet, jx, px = _pointnet(kind)
    variables = _carry(jnet, pnet, rng, jx)
    ref, upd = jax.jit(lambda v, x: jnet.apply(
        v, x, mutable=["batch_stats"]))(variables, jx)
    pnet.train()
    _close(pnet(px), ref)
    buffers = dict(pnet.named_buffers())
    for name, want in from_flax({"batch_stats": upd["batch_stats"]}).items():
        _close(buffers[name], want.numpy(), err_msg=name)
    ref_eval = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        {**variables, "batch_stats": upd["batch_stats"]}, jx)
    pnet.eval()
    with torch.no_grad():
        _close(pnet(px), ref_eval)


def _classifier(name):
    jcls = {"minkfcnn": mm.MinkowskiFCNN,
            "minksplatfcnn": mm.MinkowskiSplatFCNN}[name]
    pcls = {"minkfcnn": mp.models.MinkowskiFCNN,
            "minksplatfcnn": mp.models.MinkowskiSplatFCNN}[name]
    return jcls(out_channel=4, **NARROW), pcls(4, **NARROW, device="cpu")


@pytest.mark.parametrize("name", ["minkfcnn", "minksplatfcnn"])
def test_classifier_step_matches_jax(rng, name):
    """Train mode: logits, running statistics, the loss and every gradient
    of one step; then eval mode."""
    batch = _batch(first=2)
    jf, pf = _fields(batch)
    labels = jnp.asarray(batch[3].astype(np.int32))
    jnet, pnet = _classifier(name)
    variables = _carry(jnet, pnet, rng, jf)

    def loss_fn(params, batch_stats):  # the example's loss
        logits, upd = jnet.apply(
            {"params": params, "batch_stats": batch_stats}, jf,
            mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        return loss, (logits, upd["batch_stats"])

    (loss, (logits, new_bs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"])
    pnet.train()
    got = pnet(pf)
    _close(got, logits)
    buffers = dict(pnet.named_buffers())
    for bname, want in from_flax({"batch_stats": new_bs}).items():
        _close(buffers[bname], want.numpy(), err_msg=bname)
    pnet.load_state_dict(from_flax(variables, pnet))  # the stats before
    ploss, _ = tc.build_loss_fn(batch_size=B, extent=EXTENT,
                                device="cpu")(pnet, batch)
    ploss.backward()
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=1e-5)
    named = dict(pnet.named_parameters())
    ref_grads = from_flax({"params": grads})
    assert set(ref_grads) == set(named)
    # The splat variant within 6e-4 of each tensor's own max: its splat and
    # interpolation (multilinear weights on float32 coordinates at strides
    # 2 to 128) make the step ill-conditioned in float32.  Against the port
    # in float64 on the same float32 coordinates, JAX's float32 gradients
    # are up to 2.9e-3 of a tensor's own max away and the port's up to
    # 2.6e-3; the two float32 gradients are up to 4.84e-4 apart
    # (final_bn0's bias).  MinkowskiFCNN's are within 8e-6 of float64
    # (`tests/splat_step_vs_f64.py` prints these distances).
    rel = 6 * REL if name == "minksplatfcnn" else REL
    for gname, ref in ref_grads.items():
        ref = ref.numpy()
        np.testing.assert_allclose(
            _np(named[gname].grad), ref, rtol=0,
            atol=rel * max(np.abs(ref).max(), 1e-30), err_msg=gname)
    ref_eval = jax.jit(lambda v, f: jnet.apply(v, f, train=False))(
        {**variables, "batch_stats": new_bs}, jf)
    pnet.eval()
    with torch.no_grad():
        _close(pnet(pf), ref_eval)


def test_dropout_only_with_a_generator():
    _, pf = _fields(_batch())
    net = mp.models.MinkowskiPointNet(4, 16, device="cpu", seed=1)
    net.train()
    base = net(pf)
    np.testing.assert_array_equal(_np(net(pf)), _np(base))
    g = torch.Generator().manual_seed(0)
    assert not torch.equal(net(pf, g), base)
    net.eval()
    with torch.no_grad():
        np.testing.assert_array_equal(
            _np(net(pf, torch.Generator().manual_seed(0))), _np(net(pf)))
    h = torch.ones(1000)
    d = mp.models.pointnet.dense_dropout(h, 0.5,
                                         torch.Generator().manual_seed(3))
    assert set(torch.unique(d).tolist()) == {0.0, 2.0}


@pytest.mark.parametrize("network", ["minkfcnn", "pointnet"])
def test_train_classification_entry_point(capsys, network):
    out = tc.main(["--device", "cpu", "--network", network,
                   "--resolution", "32", "--num_points", "64",
                   "--batch_size", "2", "--steps", "2"])
    assert np.isfinite(out["final_loss"]) and 0.0 <= out["val_acc"] <= 1.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        out


def test_classification_data_flag_raises(tmp_path):
    """``--data`` reads ModelNet40's tree (its runs are held against JAX's
    in ``test_torch_mesh_data.py``); a root without meshes has no sample
    for the first batch, and raises as the example does."""
    with pytest.raises(IndexError):
        tc.main(["--device", "cpu", "--data", str(tmp_path / "ModelNet40")])
