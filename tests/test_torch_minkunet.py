"""The port's MinkUNet family and the segmentation entry point against the
JAX package, on the CPU, float32.

Weights: random flax variables (shapes from ``jax.eval_shape`` of
``init``, no compile) carried into the port by ``utils.convert``
(``load_flax``: one-to-one cover and shapes checked); the same numpy
inputs.  Voxel grids compare exactly; logits and BatchNorm statistics
within 1e-4·max|ref|; one train step's loss within 1e-5 relative and every
gradient within 1e-4·max|ref| of that tensor's ``jax.value_and_grad``.

- ``make_room`` equal to the example's, draw for draw.
- The reference behaviour of MinkUNet's capacities at the segmentation
  defaults (2 rooms of seed 42, 2,368 voxels): the stride-2 level has
  1,000 cells for its 512 rows and the stride-4 level 266 for 64; both
  packages keep the same lowest keys.
- Narrow MinkUNet14 and MinkUNet50 (bottleneck) forwards in train mode
  (logits, running statistics), MinkUNet14's in eval mode too, and one MinkUNet14 train
  step of the segmentation loss (``make_grid`` + ``reduce_by_inverse(...,
  "first")`` for features and labels, the masked cross-entropy).
- ``train.segmentation`` (``python -m ...train.segmentation``) for 2 steps
  with ``--device cpu`` at tiny flags.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import models as mm
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.train import segmentation as seg
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (from_flax,
                                                                  load_flax)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
import segmentation_indoor as jseg  # noqa: E402

torch.set_num_threads(1)
REL = 1e-4
RES, B, VOX = 16, 2, 256
CAP = B * VOX
NARROW = dict(planes=(4, 8, 8, 8, 8, 8, 4, 4), init_dim=4,
              input_capacity=CAP)


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
    """Kernels at their initialisers' scale (kaiming over K·Cin, LeCun
    over the input), the other leaves N(0, 0.3²), variances positive."""
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


def _rooms(seed=42, res=RES, vox=VOX):
    return seg.collate(np.random.RandomState(seed), batch_size=B,
                       resolution=res, voxels_per_room=vox)


def _jax_build(cpad, valid, feats, labels, cap, res):
    """`examples/segmentation_indoor.py`'s ``build``."""
    grid, inverse, _ = mt.ops.make_grid(cpad, valid, cap, batch_size=B,
                                        extent=(res,) * 3)
    f = mt.ops.reduce_by_inverse(feats, inverse, valid, cap, "first")
    lab = mt.ops.reduce_by_inverse(labels[:, None].astype(jnp.float32),
                                   inverse, valid, cap, "first")
    st = mt.SparseTensor(grid=grid, features=f).mask_features()
    return st, jnp.where(grid.valid, lab[:, 0].astype(jnp.int32), -1)


def test_make_room_matches_example():
    for res, n in ((32, 2048), (16, 256)):
        a, b = np.random.RandomState(3), np.random.RandomState(3)
        for _ in range(2):
            for got, ref in zip(seg.make_room(a, res, n),
                                jseg.make_room(b, res, n)):
                assert got.dtype == ref.dtype
                np.testing.assert_array_equal(got, ref)


def test_capacity_overflow_keeps_lowest_keys():
    """At the segmentation defaults the down levels overflow their
    ``max(cap // 8^i, 64)`` buffers; both packages keep the same rows."""
    batch = _rooms(seed=42, res=32, vox=2048)
    st, _ = seg.build(*batch, batch_size=B, resolution=32, device="cpu")
    assert int(st.valid.sum()) == 2368
    jst, _ = jax.jit(lambda *a: _jax_build(*a, 2 * 2048, 32))(
        *(jnp.asarray(a) for a in batch))
    np.testing.assert_array_equal(_np(st.grid.coords),
                                  np.asarray(jst.grid.coords))
    pg, jg = st.grid, jst.grid
    for i, (cells, rows) in enumerate(((1000, 512), (266, 64)), start=1):
        cap = max(4096 // 8 ** i, 64)
        assert cap == rows
        # the input's cells at stride 2^i, and those of the capped chain
        assert int(mp.ops.stride_grid(st.grid, 2 ** i, 4096).valid.sum()
                   ) == cells
        full = mp.ops.stride_grid(pg, 2, 4096)
        assert int(full.valid.sum()) > rows
        pg = mp.ops.stride_grid(pg, 2, cap)
        jg = jax.jit(lambda g, c=cap: mt.ops.stride_grid(g, 2, c))(jg)
        np.testing.assert_array_equal(_np(pg.coords), np.asarray(jg.coords))
        assert int(pg.valid.sum()) == rows
        # the kept rows are the level's first in canonical (key) order
        kept = mp.ops.grid_lookup(full, pg.coords, pg.valid)
        assert sorted(kept[pg.valid].tolist()) == list(range(rows))


@pytest.mark.parametrize("name", ["MinkUNet14", "MinkUNet50"])
def test_minkunet_forward_matches_jax(rng, name):
    batch = _rooms()
    st, _ = seg.build(*batch, batch_size=B, resolution=RES, device="cpu")
    jst, _ = jax.jit(lambda *a: _jax_build(*a, CAP, RES))(
        *(jnp.asarray(a) for a in batch))
    jnet = getattr(mm, name)(out_channels=3, **NARROW)
    pnet = getattr(mp.models, name)(3, **NARROW, device="cpu")
    variables = _carry(jnet, pnet, rng, jst)
    ref, upd = jax.jit(lambda v, x: jnet.apply(
        v, x, mutable=["batch_stats"]))(variables, jst)
    pnet.train()
    got = pnet(st)
    np.testing.assert_array_equal(_np(got.grid.coords),
                                  np.asarray(ref.grid.coords))
    _close(got.features, ref.features)
    buffers = dict(pnet.named_buffers())
    for bname, want in from_flax({"batch_stats": upd["batch_stats"]}
                                 ).items():
        _close(buffers[bname], want.numpy(), err_msg=bname)
    if name != "MinkUNet14":  # eval mode once: the blocks are shared
        return
    ref_eval = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        {**variables, "batch_stats": upd["batch_stats"]}, jst)
    pnet.eval()
    with torch.no_grad():
        _close(pnet(st).features, ref_eval.features)


def test_minkunet_step_matches_jax(rng):
    """One train step of the segmentation loss: loss and every gradient."""
    batch = _rooms(seed=5)
    jnet = mm.MinkUNet14(out_channels=3, **NARROW)
    pnet = mp.models.MinkUNet14(3, **NARROW, device="cpu")
    jb = tuple(jnp.asarray(a) for a in batch)
    jst, _ = jax.jit(lambda *a: _jax_build(*a, CAP, RES))(*jb)
    variables = _carry(jnet, pnet, rng, jst)

    def loss_fn(params, batch_stats):  # examples/segmentation_indoor.py
        st, labels = _jax_build(*jb, CAP, RES)
        out, upd = jnet.apply({"params": params, "batch_stats": batch_stats},
                              st, mutable=["batch_stats"])
        mask = out.valid & (labels >= 0)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            out.features, jnp.maximum(labels, 0))
        loss = jnp.sum(jnp.where(mask, ce, 0.0)) / jnp.maximum(
            jnp.sum(mask), 1)
        return loss, upd["batch_stats"]

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"])
    pnet.train()
    ploss, _ = seg.build_loss_fn(batch_size=B, resolution=RES,
                                 device="cpu")(pnet, batch)
    ploss.backward()
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=1e-5)
    named = dict(pnet.named_parameters())
    ref_grads = from_flax({"params": grads})
    assert set(ref_grads) == set(named)
    for gname, ref in ref_grads.items():
        _close(named[gname].grad, ref.numpy(), err_msg=gname)
    buffers = dict(pnet.named_buffers())
    for bname, want in from_flax({"batch_stats": new_bs}).items():
        _close(buffers[bname], want.numpy(), err_msg=bname)


def test_train_segmentation_entry_point(capsys):
    out = seg.main(["--device", "cpu", "--model", "MinkUNet14",
                    "--resolution", "16", "--voxels_per_room", "256",
                    "--steps", "2"])
    assert np.isfinite(out["final_loss"]) and 0.0 <= out["acc"] <= 1.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        out
