"""The port's fused sparse conv against the JAX package.

On the CPU the port's ``fused_sparse_conv`` takes its plain version; it is
held against JAX's Pallas kernel in interpret mode
(``compute_dtype=float32, interpret=True``) and against JAX's
``sparse_conv_apply(kernel_map(...))``, at rtol = atol = 2e-5 (float32,
summation order only).  The CUDA kernel itself runs only on the card
(`tests/test_torch_cuda.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.ops import fused_conv

torch.set_num_threads(1)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _tensors(rng, n, cap, cin, ext, bsz, empty=False):
    """The same sparse tensor (random voxels, random features) in both."""
    coords = []
    for b in range(bsz):
        c = np.unique(rng.randint(0, ext, (n, 3)), axis=0)
        coords.append(np.concatenate([np.full((len(c), 1), b, np.int32), c],
                                     1))
    coords = np.concatenate(coords).astype(np.int32)
    cpad, valid = mp.ops.pad_to_capacity(coords, cap)
    if empty:
        valid[:] = False
    feats = (rng.randn(cap, cin) * valid[:, None]).astype(np.float32)
    jst = jax.jit(lambda c, f, v: mt.sparse_tensor(
        c, f, capacity=cap, valid=v, batch_size=bsz, extent=(ext,) * 3))(
        jnp.asarray(cpad), jnp.asarray(feats), jnp.asarray(valid))
    pst = mp.sparse_tensor(_t(cpad), _t(feats), capacity=cap, valid=_t(valid),
                           batch_size=bsz, extent=(ext,) * 3)
    np.testing.assert_array_equal(_np(pst.grid.coords),
                                  np.asarray(jst.grid.coords))
    return jst, pst


CASES = {
    # name: (cin, cout, bsz, kernel spec kwargs, geometry)
    "k3s1": (3, 16, 2, dict(kernel_size=3), "same"),
    "k3s1_cin1": (1, 8, 2, dict(kernel_size=3), "same"),
    "k3s2": (5, 7, 2, dict(kernel_size=3, stride=2), "down"),
    "k2s2_pinned_transpose": (5, 6, 2, dict(kernel_size=2, stride=2,
                                            transpose=True), "up"),
    "k2s2_generative": (4, 6, 2, dict(kernel_size=2, stride=2,
                                      transpose=True), "grow"),
    "empty": (3, 5, 1, dict(kernel_size=3), "empty"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fused_plain_matches_jax(rng, name):
    cin, cout, bsz, kw, geom = CASES[name]
    jst, pst = _tensors(rng, 300, 512, cin, 12, bsz, empty=geom == "empty")
    spec, pspec = mt.ops.KernelSpec(ndim=3, **kw), mp.ops.KernelSpec(ndim=3,
                                                                     **kw)
    jin, pin, feats = jst.grid, pst.grid, jst.features
    if geom in ("same", "empty"):
        jout, pout = jin, pin
    elif geom == "down":
        jout = jax.jit(lambda g: mt.ops.stride_grid(g, 2, 512))(jin)
        pout = mp.ops.stride_grid(pin, 2, 512)
    else:
        # input on the stride-2 grid; output on the fine grid ("up") or on
        # the octree children grown from it ("grow")
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
    bias = rng.randn(cout).astype(np.float32)

    nbr = jax.jit(lambda a, b: mt.ops.kernel_map(a, b, spec))(jin, jout)
    ref_xla = jax.jit(lambda f, k, b: mt.ops.sparse_conv_apply(f, k, nbr, b))(
        feats, jnp.asarray(kern), jnp.asarray(bias))
    ref_pallas = mt.ops.fused_sparse_conv(
        feats, jnp.asarray(kern), jin, jout, spec, jnp.asarray(bias),
        tile=128, tw=128, compute_dtype=jnp.float32, interpret=True)
    launches = fused_conv.fused_sparse_conv.launches
    got = _np(mp.ops.fused_sparse_conv(_t(feats), _t(kern), pin, pout, pspec,
                                       _t(bias)))
    assert fused_conv.fused_sparse_conv.launches == launches  # CPU: no kernel
    np.testing.assert_allclose(got, np.asarray(ref_pallas), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(ref_xla), rtol=2e-5, atol=2e-5)
    if geom == "empty":
        assert np.all(got == bias)


def test_query_keys_and_neighbor_index_match_kernel_map(rng):
    """The plain version's search equals JAX's kernel map row for row."""
    jst, pst = _tensors(rng, 200, 256, 1, 10, 2)
    jout = jax.jit(lambda g: mt.ops.stride_grid(g, 2, 256))(jst.grid)
    pout = mp.ops.stride_grid(pst.grid, 2, 256)
    for kw, (ji, jo, pi, po) in (
            (dict(kernel_size=3, stride=2),
             (jst.grid, jout, pst.grid, pout)),
            (dict(kernel_size=2, stride=2, transpose=True),
             (jout, jst.grid, pout, pst.grid))):
        spec = mt.ops.KernelSpec(ndim=3, **kw)
        nbr = jax.jit(lambda a, b: mt.ops.kernel_map(a, b, spec))(ji, jo)
        offs, s_in, cells = fused_conv.conv_geometry(
            pi, mp.ops.KernelSpec(ndim=3, **kw))
        qk = fused_conv.query_keys(po.coords, po.valid, offs, s_in, cells)
        idx = fused_conv.neighbor_index(pi.flat_keys(), qk)
        np.testing.assert_array_equal(_np(idx).T, np.asarray(nbr))


def test_sparse_conv_apply_matches_jax(rng):
    """The port's kernel-map gather-GEMM (both schedules) against JAX."""
    jst, pst = _tensors(rng, 300, 512, 4, 12, 2)
    spec = mt.ops.KernelSpec(3, 1, ndim=3)
    nbr = jax.jit(lambda g: mt.ops.kernel_map(g, g, spec))(jst.grid)
    kern = (rng.randn(27, 4, 5) * 0.1).astype(np.float32)
    ref = jax.jit(lambda f, k: mt.ops.sparse_conv_apply(f, k, nbr))(
        jst.features, jnp.asarray(kern))
    for thr in (None, 0):  # one GEMM / K looped GEMMs
        got = mp.ops.sparse_conv_apply(pst.features, _t(kern),
                                       _t(np.asarray(nbr)),
                                       fused_threshold=thr)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)
