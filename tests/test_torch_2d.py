"""Grids of D = 2 in the port against the JAX package (`tests/test_2d.py`).

- A 2-D k3 ``SparseConv`` on a full 6x6 grid (the dense route, as in JAX)
  and the fused conv on the same operands: the port's outputs against
  JAX's and against a dense conv, and a 2-D down/up round trip (k2 s2 conv,
  k2 s2 transpose) against JAX's, at `test_2d.py`'s tolerances (rtol 2e-4,
  atol 1e-4), with the same seeded inputs and JAX's weights.
- The 2-D geometry the CUDA kernels take (``Geom.ndim``, a coordinate row
  of 1 + D ints): the port's flat keys and its query keys / matches, on
  strided and transposed 2-D convs, equal JAX's ``flat_cell_key`` and
  ``kernel_map``, and so does the other form the kernels could have taken
  (the grid as 3-D with a unit last axis: a zero offset, stride 1, one
  cell); the plain fused conv gives the same output from both.  The
  kernels themselves run on the card (`chip_smoke.py`'s domain phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu.ops import coords as jcoords
from mink_octtree_stablediffusion_tpu import nn as mnn
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.ops import fused_conv

torch.set_num_threads(1)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _port_conv(module, params):
    """Load a flax conv's kernel [K, Cin, Cout] into the port's conv."""
    with torch.no_grad():
        module.kernel.copy_(_t(params["params"]["kernel"]))
    return module


def test_2d_sparse_conv_equals_jax_and_dense(rng):
    res, cin, cout = 6, 3, 4
    g = np.stack(np.meshgrid(np.arange(res), np.arange(res),
                             indexing="ij"), -1).reshape(-1, 2)
    coords = np.concatenate([np.zeros((len(g), 1), np.int32), g],
                            1).astype(np.int32)
    feats = rng.randn(len(coords), cin).astype(np.float32)
    st = jax.jit(lambda c, f: mt.sparse_tensor(
        c, f, capacity=len(coords), extent=(res, res)))(
        jnp.asarray(coords), jnp.asarray(feats))
    conv = mnn.SparseConv(cout, kernel_size=3, ndim=2)
    params = conv.init(jax.random.PRNGKey(0), st)
    ref = np.asarray(jax.jit(lambda p, s: conv.apply(p, s))(params, st).F)

    pst = mp.sparse_tensor(_t(coords), _t(feats), capacity=len(coords),
                           extent=(res, res))
    assert pst.grid.ndim == 2
    np.testing.assert_array_equal(_np(pst.grid.coords), np.asarray(st.C))
    pconv = _port_conv(mp.nn.SparseConv(cin, cout, kernel_size=3, ndim=2),
                       params)
    with mp.nn.record_routes() as routes:
        out = pconv(pst)
    # a full grid takes the dense no-growth route, as in JAX; the fused
    # route (B1 on the card) computes the same conv
    assert [r.branch for r in routes] == ["dense"]
    on = _np(out.features)
    np.testing.assert_allclose(on, ref, rtol=2e-4, atol=1e-4)
    fused = mp.ops.fused_sparse_conv(pst.features, pconv.kernel, pst.grid,
                                     pst.grid, pconv.spec)
    np.testing.assert_allclose(_np(fused), ref, rtol=2e-4, atol=1e-4)

    dense_in = np.zeros((1, cin, res, res), np.float32)
    for i, (b, x, y) in enumerate(coords):
        dense_in[0, :, x, y] = feats[i]
    kernel = np.asarray(params["params"]["kernel"]).reshape(3, 3, cin, cout)
    dn = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(dense_in), jnp.asarray(np.transpose(kernel, (3, 2, 0, 1))),
        (1, 1), "SAME"))
    cn, valid = _np(out.grid.coords), _np(out.grid.valid)
    for i in range(out.capacity):
        if valid[i]:
            b, x, y = cn[i]
            np.testing.assert_allclose(on[i], dn[0, :, x, y], rtol=2e-4,
                                       atol=1e-4)


def test_2d_down_up_roundtrip_matches_jax(rng):
    coords = np.concatenate(
        [np.zeros((32, 1), np.int32), rng.randint(0, 8, (32, 2))],
        axis=1).astype(np.int32)
    cpad, valid = mt.ops.pad_to_capacity(coords, 32)
    feats = (rng.randn(32, 4) * valid[:, None]).astype(np.float32)
    st = jax.jit(lambda c, f, v: mt.sparse_tensor(
        c, f, capacity=32, valid=v, extent=(8, 8)))(
        jnp.asarray(cpad), jnp.asarray(feats), jnp.asarray(valid))
    down = mnn.SparseConv(8, kernel_size=2, stride=2, ndim=2, out_capacity=16)
    pdown = down.init(jax.random.PRNGKey(0), st)
    mid = jax.jit(lambda p, s: down.apply(p, s))(pdown, st)
    up = mnn.SparseConvTranspose(4, kernel_size=2, stride=2, ndim=2)
    pup = up.init(jax.random.PRNGKey(1), mid, st.grid)
    out = jax.jit(lambda p, m, g: up.apply(p, m, g))(pup, mid, st.grid)

    pst = mp.sparse_tensor(_t(cpad), _t(feats), capacity=32, valid=_t(valid),
                           extent=(8, 8))
    pd = _port_conv(mp.nn.SparseConv(4, 8, kernel_size=2, stride=2, ndim=2,
                                     out_capacity=16), pdown)
    pu = _port_conv(mp.nn.SparseConvTranspose(8, 4, kernel_size=2, stride=2,
                                              ndim=2), pup)
    with mp.nn.record_routes() as routes:
        pmid = pd(pst)
        pout = pu(pmid, pst.grid)
    assert [r.branch for r in routes] == ["fused", "fused"]
    assert tuple(pmid.grid.stride) == (2, 2)
    np.testing.assert_array_equal(_np(pmid.grid.coords), np.asarray(mid.C))
    np.testing.assert_allclose(_np(pmid.features), np.asarray(mid.F),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_array_equal(_np(pout.grid.coords), np.asarray(st.C))
    np.testing.assert_allclose(_np(pout.features), np.asarray(out.F),
                               rtol=2e-4, atol=1e-4)


def _unit_axis(coords, offs, s_in, cells):
    """The 2-D geometry as 3-D with a unit last axis."""
    c3 = torch.cat([coords, torch.zeros_like(coords[:, :1])], 1)
    o3 = np.concatenate([offs, np.zeros_like(offs[:, :1])], 1)
    return c3, o3, tuple(s_in) + (1,), list(cells) + [1]


@pytest.mark.parametrize("form", ["ndim", "unit_axis"])
def test_2d_geometry_gives_jax_flat_keys_and_matches(rng, form):
    """The kernels' 2-D search (plain versions ``query_keys`` /
    ``neighbor_index``) equals JAX's ``kernel_map`` on a strided and a
    transposed 2-D conv, with the keys JAX's ``flat_cell_key`` gives."""
    coords = []
    for b in range(2):
        c = np.unique(rng.randint(0, 10, (60, 2)), axis=0)
        coords.append(np.concatenate([np.full((len(c), 1), b, np.int32), c],
                                     1))
    cpad, valid = mt.ops.pad_to_capacity(np.concatenate(coords), 128)
    jst = jax.jit(lambda c, v: mt.sparse_tensor(
        c, jnp.ones((128, 3)), capacity=128, valid=v, batch_size=2,
        extent=(10, 10)))(jnp.asarray(cpad), jnp.asarray(valid))
    pst = mp.sparse_tensor(_t(cpad), torch.ones(128, 3), capacity=128,
                           valid=_t(valid), batch_size=2, extent=(10, 10))
    jout = jax.jit(lambda g: mt.ops.stride_grid(g, 2, 64))(jst.grid)
    pout = mp.ops.stride_grid(pst.grid, 2, 64)
    for grid, jgrid in ((pst.grid, jst.grid), (pout, jout)):
        np.testing.assert_array_equal(_np(grid.coords),
                                      np.asarray(jgrid.coords))
        np.testing.assert_array_equal(_np(grid.flat_keys()), np.asarray(
            jcoords.flat_cell_key(jgrid.coords, jgrid.valid, jgrid.stride,
                                 jgrid.extent)))
    feats = rng.randn(128, 3).astype(np.float32)
    for kw, (ji, jo, pi, po) in (
            (dict(kernel_size=3, stride=2), (jst.grid, jout, pst.grid, pout)),
            (dict(kernel_size=2, stride=2, transpose=True),
             (jout, jst.grid, pout, pst.grid))):
        spec = mt.ops.KernelSpec(ndim=2, **kw)
        nbr = jax.jit(lambda a, b: mt.ops.kernel_map(a, b, spec))(ji, jo)
        offs, s_in, cells = fused_conv.conv_geometry(
            pi, mp.ops.KernelSpec(ndim=2, **kw))
        assert offs.shape[1] == 2
        qc = po.coords
        if form == "unit_axis":
            qc, offs, s_in, cells = _unit_axis(qc, offs, s_in, cells)
        qk = fused_conv.query_keys(qc, po.valid, offs, s_in, cells)
        idx = fused_conv.neighbor_index(pi.flat_keys(), qk)
        np.testing.assert_array_equal(_np(idx).T, np.asarray(nbr))
        kern = (rng.randn(offs.shape[0], 3, 5) * 0.1).astype(np.float32)
        f = _t(feats[:pi.capacity]) * pi.valid[:, None]
        got = fused_conv._fused_sparse_conv_plain(
            f, _t(kern), pi.flat_keys(), qc, po.valid, offs, s_in, cells,
            torch.float32)
        ref = jax.jit(lambda f, k: mt.ops.sparse_conv_apply(f, k, nbr))(
            jnp.asarray(_np(f)), jnp.asarray(kern))
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)
