"""The port's brick route (`ops/brick.py`, `ops/vol_conv.py`) against the
JAX package, on the CPU in float32.

- The brick layout, ``to_bricks`` and ``from_bricks`` match exactly;
  ``brick_conv_xla`` within 2e-5·max|ref|.
- ``vol_conv3d`` (the plain version of B5 on CPU tensors) against JAX's
  ``vol_conv`` in interpret mode.
- ``brick_pallas_conv``'s forward, dF and dW (its ``BrickConv`` backward:
  the plain versions of B5's dF pass and B6, not autograd of the plain
  forward) against ``jax.vjp`` of JAX's interpret-mode
  ``brick_pallas_conv`` on three cases: the 6→5 conv of
  `tests/test_pallas.py`, a stride-2 grid and a 4→4 conv.  Tolerance
  2e-5·max|ref| per tensor (float32; the sums run in another order).
- ``brick_pallas_applicable`` and ``brick_preferred`` against JAX's on a
  table of specs and grids, with JAX's CPU-backend clause taken out
  (``jax.default_backend`` reads "tpu" in that test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu.ops import brick as jbrick
from mink_octtree_stablediffusion_tpu.ops import vol_conv as jvc
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.ops import brick as pbrick
from mink_octtree_stablediffusion_tpu_torch.ops import vol_conv as pvc

torch.set_num_threads(1)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, rel=2e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _grids(rng, n, cap, ext, bsz, stride=1):
    """The same grid (random voxels, coarsened by ``stride``) in both."""
    coords = np.concatenate([rng.randint(0, bsz, (n, 1)),
                             rng.randint(0, ext, (n, 3))], 1).astype(np.int32)
    cpad, valid = mt.ops.pad_to_capacity(coords, cap)

    def jgrid(c, v):
        g = mt.sparse_tensor(c, jnp.zeros((cap, 1)), capacity=cap,
                             batch_size=bsz, valid=v, extent=(ext,) * 3).grid
        return mt.ops.stride_grid(g, stride, cap) if stride > 1 else g
    jg = jax.jit(jgrid)(jnp.asarray(cpad), jnp.asarray(valid))
    pg = mp.sparse_tensor(_t(cpad), torch.zeros(cap, 1), capacity=cap,
                          batch_size=bsz, valid=_t(valid),
                          extent=(ext,) * 3).grid
    if stride > 1:
        pg = mp.ops.stride_grid(pg, stride, cap)
    np.testing.assert_array_equal(_np(pg.coords), np.asarray(jg.coords))
    np.testing.assert_array_equal(_np(pg.valid), np.asarray(jg.valid))
    return jg, pg


def test_brick_layout_and_xla_conv_match_jax(rng):
    jg, pg = _grids(rng, 500, 1024, 24, 2)
    jl, pl = jbrick.brick_layout(jg), pbrick.brick_layout(pg)
    assert (pl.nb, pl.bdims, pl.batch_size) == (jl.nb, jl.bdims,
                                                jl.batch_size)
    np.testing.assert_array_equal(_np(pl.slot), np.asarray(jl.slot))
    np.testing.assert_array_equal(_np(pl.within), np.asarray(jl.within))
    feats = (rng.randn(1024, 3) * np.asarray(jg.valid)[:, None]).astype(
        np.float32)
    jb, pb = jbrick.to_bricks(jnp.asarray(feats), jl), pbrick.to_bricks(
        _t(feats), pl)
    np.testing.assert_array_equal(_np(pb), np.asarray(jb))
    np.testing.assert_array_equal(
        _np(pbrick.from_bricks(pb, pl, pg.valid)),
        np.asarray(jbrick.from_bricks(jb, jl, jg.valid)))
    kern = (rng.randn(27, 3, 4) * 0.3).astype(np.float32)
    _close(pbrick.brick_conv_xla(pb, _t(kern), pl),
           jbrick.brick_conv_xla(jb, jnp.asarray(kern), jl))


def test_vol_conv3d_matches_jax(rng):
    vol = rng.randn(2, 16, 8, 16, 5).astype(np.float32)
    ker = (rng.randn(27, 5, 7) * 0.2).astype(np.float32)
    ref = jvc.vol_conv(jnp.asarray(vol), jnp.asarray(ker),
                       compute_dtype=jnp.float32, interpret=True)
    got = mp.ops.vol_conv3d(_t(vol), _t(ker), compute_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, ref)


BRICK_CASES = {
    # name: (capacity, batch, extent, stride, cin, cout)
    "k3s1_6to5": (1024, 2, 16, 1, 6, 5),  # tests/test_pallas.py:524
    "stride2_grid": (1024, 2, 32, 2, 6, 5),
    "narrow_4to4": (512, 2, 16, 1, 4, 4),
}


@pytest.mark.parametrize("name", list(BRICK_CASES))
def test_brick_pallas_conv_forward_and_grads_match_jax(rng, name):
    cap, bsz, ext, stride, cin, cout = BRICK_CASES[name]
    jg, pg = _grids(rng, 700, cap, ext, bsz, stride)
    valid = np.asarray(jg.valid)[:, None]
    feats = (rng.randn(cap, cin) * valid).astype(np.float32)
    kern = (rng.randn(27, cin, cout) * 0.2).astype(np.float32)
    gout = (rng.randn(cap, cout) * valid).astype(np.float32)
    spec = mt.ops.KernelSpec(3, 1, 1, ndim=3)
    assert jvc.brick_pallas_applicable(spec, jg)

    ref, vjp = jax.vjp(lambda f, k: jvc.brick_pallas_conv(
        f, k, jg, compute_dtype=jnp.float32, interpret=True),
        jnp.asarray(feats), jnp.asarray(kern))
    ref_df, ref_dk = vjp(jnp.asarray(gout))

    f = _t(feats).requires_grad_()
    k = _t(kern).requires_grad_()
    out = mp.ops.brick_pallas_conv(f, k, pg, compute_dtype=torch.float32)
    out.backward(_t(gout))
    for got, want in ((out, ref), (f.grad, ref_df), (k.grad, ref_dk)):
        _close(got, want)


def _routing_table():
    """(spec kwargs, extent, stride, batch) pairs around every clause of
    the rule: kernel size, stride, dilation, transpose, region type, cell
    alignment, the z ≤ 256 bound and the 4,194,304-cell cap."""
    specs = [dict(kernel_size=3), dict(kernel_size=3, stride=2),
             dict(kernel_size=2), dict(kernel_size=3, dilation=2),
             dict(kernel_size=3, transpose=True),
             dict(kernel_size=3, region="cross")]
    grids = [((16, 16, 16), 1, 2), ((128, 128, 128), 8, 4),
             ((128, 128, 128), 2, 4), ((128, 128, 128), 1, 2),
             ((128, 128, 128), 1, 3), ((24, 24, 20), 1, 1),
             ((8, 8, 512), 1, 1), ((8, 8, 256), 1, 1)]
    return [(s, g) for s in specs for g in grids]


def _spec(pkg, kw):
    kw = dict(kw)
    if kw.pop("region", None) == "cross":
        kw["region_type"] = pkg.ops.RegionType.HYPER_CROSS
    return pkg.ops.KernelSpec(ndim=3, **kw)


def test_brick_routing_matches_jax(monkeypatch):
    rows = 4
    jcoords = jnp.zeros((rows, 4), jnp.int32)
    for kw, (extent, stride, bsz) in _routing_table():
        jg = mt.ops.SparseGrid(coords=jcoords, valid=jnp.ones(rows, bool),
                               stride=(stride,) * 3, batch_size=bsz,
                               extent=extent)
        pg = mp.ops.SparseGrid(coords=torch.zeros(rows, 4, dtype=torch.int32),
                               valid=torch.ones(rows, dtype=torch.bool),
                               stride=(stride,) * 3, batch_size=bsz,
                               extent=extent)
        js, ps = _spec(mt, kw), _spec(mp, kw)
        assert (pvc.brick_pallas_applicable(ps, pg) ==
                jvc.brick_pallas_applicable(js, jg)), (kw, extent, stride)
        for cin, cout in ((4, 4), (128, 128), (129, 4), (32, 512)):
            monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
            for flag in (False, True):
                jvc.enable_brick_conv(flag)
                pvc.enable_brick_conv(flag)
                try:
                    want = jvc.brick_preferred(js, jg, cin, cout)
                    got = pvc.brick_preferred(ps, pg, cin, cout, "cuda")
                    on_cpu = pvc.brick_preferred(ps, pg, cin, cout, "cpu")
                finally:
                    jvc.enable_brick_conv(False)
                    pvc.enable_brick_conv(False)
                assert got == want, (kw, extent, stride, cin, cout, flag)
                assert not on_cpu
            monkeypatch.undo()
    # the table reaches both answers
    assert any(pvc.brick_pallas_applicable(_spec(mp, kw), mp.ops.SparseGrid(
        coords=torch.zeros(rows, 4, dtype=torch.int32),
        valid=torch.ones(rows, dtype=torch.bool), stride=(s,) * 3,
        batch_size=b, extent=e)) for kw, (e, s, b) in _routing_table())
