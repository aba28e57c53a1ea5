"""The port's coordinate engine and small reductions against the JAX
package: the same numpy inputs through both, compared exactly (integers)
or at 1e-5 (float32 features)."""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.utils import device as pdevice

torch.set_num_threads(1)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _t(a):
    return torch.as_tensor(np.array(a))


def random_coords(rng, n, batch=4, res=64, d=3):
    b = rng.randint(0, batch, size=(n, 1))
    xyz = rng.randint(0, res, size=(n, d))
    return np.concatenate([b, xyz], axis=1).astype(np.int32)


def _grids(coords, valid, cap, stride, bsz, res):
    """The same canonical grid built by both packages."""
    ext = (res,) * 3
    jg, _, _ = jax.jit(lambda c, v: mt.ops.make_grid(
        c, v, cap, stride, bsz, extent=ext))(jnp.asarray(coords),
                                             jnp.asarray(valid))
    pg, _, _ = mp.ops.make_grid(_t(coords), _t(valid), cap, stride, bsz,
                                extent=ext)
    return jg, pg


def _same_grid(jg, pg):
    np.testing.assert_array_equal(_np(pg.coords), np.asarray(jg.coords))
    np.testing.assert_array_equal(_np(pg.valid), np.asarray(jg.valid))
    assert pg.stride == jg.stride and pg.extent == jg.extent


@pytest.mark.parametrize("stride,res,bsz,cap", [
    (1, 64, 3, 800), (4, 64, None, 800), (8, 32, 3, 800), (1, 64, 3, 300)])
def test_unique_coords_matches_jax(rng, stride, res, bsz, cap):
    """Bounded dedup (LUT inverse with batch_size, searchsorted without,
    and a capacity overflow) gives the same coords, valid, inverse, count."""
    coords = random_coords(rng, 700, batch=3, res=res)
    valid = rng.rand(700) > 0.1
    coords[~valid] = mt.ops.INVALID_COORD
    ext = (res,) * 3
    ref = jax.jit(lambda c, v: mt.ops.unique_coords(
        c, v, cap, stride, extent=ext, batch_size=bsz))(
        jnp.asarray(coords), jnp.asarray(valid))
    got = mp.ops.unique_coords(_t(coords), _t(valid), cap, stride,
                               extent=ext, batch_size=bsz)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_np(g), np.asarray(r))


def test_stride_expand_grid_match_jax(rng):
    coords = random_coords(rng, 300, batch=2, res=32)
    jg, pg = _grids(coords, np.ones(300, bool), 400, 1, 2, 32)
    _same_grid(jg, pg)
    js = jax.jit(lambda g: mt.ops.stride_grid(g, 2, 256))(jg)
    ps = mp.ops.stride_grid(pg, 2, 256)
    _same_grid(js, ps)
    spec = mt.ops.KernelSpec(2, 2, ndim=3, transpose=True)
    offs = spec.absolute_offsets(js.stride)
    je = jax.jit(lambda g: mt.ops.expand_grid(g, offs, (1, 1, 1), 1024))(js)
    pe = mp.ops.expand_grid(ps, offs, (1, 1, 1), 1024)
    _same_grid(je, pe)


def test_lookups_kernel_map_membership_match_jax(rng):
    """LUT lookup, sorted flat-key lookup, kernel maps (k3s1, k3s2, k2s2
    transpose) and membership: identical int32 maps."""
    coords = random_coords(rng, 200, batch=2, res=16)
    jg, pg = _grids(coords, np.ones(200, bool), 256, 1, 2, 16)
    q = coords.copy()
    q[:, 1:] += rng.randint(-2, 3, (200, 3))  # off-grid / out-of-extent
    qv = rng.rand(200) > 0.2
    ref = jax.jit(lambda g, q, v: mt.ops.grid_lookup(g, q, v))(
        jg, jnp.asarray(q), jnp.asarray(qv))
    np.testing.assert_array_equal(
        _np(mp.ops.grid_lookup(pg, _t(q), _t(qv))), np.asarray(ref))
    srt = mp.ops.lookup_sorted(pg.coords, pg.valid, pg.stride, _t(q),
                               _t(qv), extent=pg.extent)
    np.testing.assert_array_equal(_np(srt), np.asarray(ref))

    js = jax.jit(lambda g: mt.ops.stride_grid(g, 2, 128))(jg)
    ps = mp.ops.stride_grid(pg, 2, 128)
    for args, pargs, spec_args in (
            ((jg, jg), (pg, pg), dict(kernel_size=3)),
            ((jg, js), (pg, ps), dict(kernel_size=3, stride=2)),
            ((js, jg), (ps, pg), dict(kernel_size=2, stride=2,
                                      transpose=True))):
        spec = mt.ops.KernelSpec(ndim=3, **spec_args)
        pspec = mp.ops.KernelSpec(ndim=3, **spec_args)
        ref = jax.jit(lambda a, b: mt.ops.kernel_map(a, b, spec))(*args)
        np.testing.assert_array_equal(
            _np(mp.ops.kernel_map(*pargs, pspec)), np.asarray(ref))
    ref = jax.jit(mt.ops.membership)(js, jax.jit(
        lambda g: mt.ops.stride_grid(g, 2, 128))(jg))
    np.testing.assert_array_equal(
        _np(mp.ops.membership(ps, mp.ops.stride_grid(pg, 2, 128))),
        np.asarray(ref))


def test_membership_case():
    coords = np.array([[0, 0, 0, 0], [0, 2, 4, 6], [1, 2, 2, 2]], np.int32)
    padded, valid = mp.ops.pad_to_capacity(coords, 8)
    grid, _, _ = mp.ops.make_grid(_t(padded), _t(valid), 8, 2, 2,
                                  extent=(8, 8, 8))
    q = np.array([[0, 0, 0, 0], [0, 2, 4, 6], [1, 0, 0, 0], [1, 2, 2, 2]],
                 np.int32)
    qp, qv = mp.ops.pad_to_capacity(q, 8)
    qgrid = mp.SparseGrid(coords=_t(qp), valid=_t(qv), stride=(2, 2, 2),
                          batch_size=2, extent=(8, 8, 8))
    m = _np(mp.ops.membership(qgrid, grid))
    assert m[:4].tolist() == [True, True, False, True]
    assert not m[4:].any()


@pytest.mark.parametrize("k_max", [5, 40, 200])
def test_prune_top_k_match_jax(rng, k_max):
    """top_k keeps strictly score > max(kth, 0) (ties at the k-th value are
    dropped) and prune compacts stably — both exactly as in JAX."""
    coords = random_coords(rng, 120, batch=2, res=16)
    jg, pg = _grids(coords, np.ones(120, bool), 128, 1, 2, 16)
    logits = np.round(rng.randn(128), 1).astype(np.float32)  # many ties
    feats = rng.randn(128, 3).astype(np.float32)
    ref_keep = jax.jit(lambda l, v: mt.ops.top_k_mask(l, v, k_max))(
        jnp.asarray(logits), jg.valid)
    keep = mp.ops.top_k_mask(_t(logits), pg.valid, k_max)
    np.testing.assert_array_equal(_np(keep), np.asarray(ref_keep))
    jpg, jf = jax.jit(lambda g, f, k: mt.ops.prune(g, f, k, 100))(
        jg, jnp.asarray(feats), ref_keep)
    ppg, pf = mp.ops.prune(pg, _t(feats), keep, 100)
    _same_grid(jpg, ppg)
    np.testing.assert_array_equal(_np(pf), np.asarray(jf))


def test_pool_broadcast_reduce_match_jax(rng):
    coords = random_coords(rng, 150, batch=3, res=16)
    coords = np.concatenate([coords, coords[:20]])  # duplicates
    valid = rng.rand(170) > 0.1
    feats = rng.randn(170, 5).astype(np.float32)
    ext = (16, 16, 16)
    for mode in ("sum", "avg", "max", "first"):
        ref = jax.jit(lambda c, f, v: mt.sparse_tensor(
            c, f, 200, 1, 4, v, mode, extent=ext).features)(
            jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(valid))
        got = mp.sparse_tensor(_t(coords), _t(feats), 200, 1, 4, _t(valid),
                               mode, extent=ext).features
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    jst = jax.jit(lambda c, f: mt.sparse_tensor(c, f, 200, 1, 4,
                                                extent=ext))(
        jnp.asarray(coords), jnp.asarray(feats))
    pst = mp.sparse_tensor(_t(coords), _t(feats), 200, 1, 4, extent=ext)
    bid, pbid = jst.grid.batch_ids(), pst.grid.batch_ids()
    for mode in ("sum", "avg", "max"):
        ref, rc = jax.jit(lambda f, b, v: mt.ops.global_pool(
            f, b, 4, v, mode))(jst.features, bid, jst.valid)
        got, gc = mp.ops.global_pool(pst.features, pbid, 4, pst.valid, mode)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(_np(gc), np.asarray(rc))
    per = rng.randn(4, 5).astype(np.float32)
    ref = jax.jit(mt.ops.broadcast_batch)(jnp.asarray(per), bid, jst.valid)
    np.testing.assert_array_equal(
        _np(mp.ops.broadcast_batch(_t(per), pbid, pst.valid)),
        np.asarray(ref))


@pytest.mark.parametrize("case", ["k3s1", "k3s2", "k2s2T"])
def test_dense_conv_matches_jax(rng, case):
    """The densify → conv → gather branch (F.conv3d / einsum in the port,
    lax.conv / einsum in JAX), fp32, at 1e-5."""
    coords = random_coords(rng, 300, batch=2, res=8)
    jg, pg = _grids(coords, np.ones(300, bool), 1024, 1, 2, 8)
    cin, cout = 5, 6
    feats = (rng.randn(1024, cin) * _np(pg.valid)[:, None]).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    if case == "k3s1":
        kw = dict(kernel_size=3)
        spec, pspec = (mt.ops.KernelSpec(ndim=3, **kw),
                       mp.ops.KernelSpec(ndim=3, **kw))
        kern = rng.randn(27, cin, cout).astype(np.float32) * 0.2
        ref = jax.jit(lambda f, k, b: mt.ops.dense_conv.dense_conv_apply(
            f, k, jg, spec, b))(jnp.asarray(feats), jnp.asarray(kern),
                                jnp.asarray(bias))
        assert mp.ops.dense_no_growth_preferred(pspec, pg)
        got = mp.ops.dense_conv_apply(_t(feats), _t(kern), pg, pspec,
                                      _t(bias))
    else:
        js = jax.jit(lambda g: mt.ops.stride_grid(g, 2, 256))(jg)
        ps = mp.ops.stride_grid(pg, 2, 256)
        if case == "k3s2":
            kw, jin, jout, pin, pout, k = (dict(kernel_size=3, stride=2), jg,
                                           js, pg, ps, 27)
        else:
            kw, jin, jout, pin, pout, k = (
                dict(kernel_size=2, stride=2, transpose=True), js, jg, ps,
                pg, 8)
            feats = feats[:256] * _np(ps.valid)[:, None]
        spec, pspec = (mt.ops.KernelSpec(ndim=3, **kw),
                       mp.ops.KernelSpec(ndim=3, **kw))
        kern = rng.randn(k, cin, cout).astype(np.float32) * 0.2
        assert mp.ops.dense_no_growth_preferred2(pspec, pin, pout)
        ref = jax.jit(lambda f, kk, b: mt.ops.dense_conv
                      .dense_conv_general_apply(f, kk, jin, jout, spec, b))(
            jnp.asarray(feats), jnp.asarray(kern), jnp.asarray(bias))
        got = mp.ops.dense_conv_general_apply(_t(feats), _t(kern), pin, pout,
                                              pspec, _t(bias))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_unbounded_grid_raises():
    coords = random_coords(np.random.RandomState(0), 10, res=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mp.ops.make_grid(_t(coords), torch.ones(10, dtype=torch.bool), 16)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, entry points raise unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdevice.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mp.models.UNet(channels=(4, 8, 8, 8), group=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mp.models.VAE(channels=(4, 4, 4, 4, 4))
    assert pdevice.resolve_device("cpu").type == "cpu"


def test_port_imports_no_jax():
    """Importing the port (and its chip smoke script's dependencies) loads
    neither JAX nor the JAX package."""
    code = ("import sys, chip_smoke, "
            "mink_octtree_stablediffusion_tpu_torch as p; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'flax' or m.startswith('flax.') or "
            "m.split('.')[0] == 'mink_octtree_stablediffusion_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True,
                       cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert r.returncode == 0, r.stdout + r.stderr
