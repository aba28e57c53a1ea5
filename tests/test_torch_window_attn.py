"""The port's Morton-window attention against the JAX package.

`nn.attention.MortonWindowTransformer` at ``interval`` 1 and 2, with
invalid rows, an empty instance and a row count that is no multiple of
``window·interval`` (float32, within 1e-5); `BasicBlock`'s choice between
window and full attention, each time on its own flax layout carried onto
the port's one set of projections; and the encoder with
``with_window_attn``, within 1e-4·max|ref|.  Parameters are randomised in
flax and carried over with ``utils.convert.load_flax`` (one-to-one
cover checked); the flax trees' shapes come from ``jax.eval_shape``, so
JAX compiles no ``init``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import models as mm
from mink_octtree_stablediffusion_tpu.nn import attention as jattn
from mink_octtree_stablediffusion_tpu.nn import blocks as jblocks
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.nn import blocks as pblocks
from mink_octtree_stablediffusion_tpu_torch.utils.convert import load_flax

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _tensors(rng, cap=301, cin=8, ext=12, bsz=3, n=70, stride=1,
             empty_instance=1):
    """The same sparse tensor in both packages: ``bsz`` instances of up to
    ``n`` voxels (``empty_instance`` holds none) in a buffer of ``cap``
    rows, the rest invalid."""
    coords = []
    for b in range(bsz):
        if b == empty_instance:
            continue
        c = np.unique(rng.randint(0, ext, (n, 3)), axis=0) * stride
        coords.append(np.concatenate([np.full((len(c), 1), b, np.int32), c],
                                     1))
    coords = np.concatenate(coords).astype(np.int32)
    cpad, valid = mp.ops.pad_to_capacity(coords, cap)
    feats = (rng.randn(cap, cin) * valid[:, None]).astype(np.float32)
    jst = jax.jit(lambda c, f, v: mt.sparse_tensor(
        c, f, capacity=cap, valid=v, batch_size=bsz, stride=stride,
        extent=(ext * stride,) * 3))(jnp.asarray(cpad), jnp.asarray(feats),
                                     jnp.asarray(valid))
    pst = mp.sparse_tensor(_t(cpad), _t(feats), capacity=cap, valid=_t(valid),
                           batch_size=bsz, stride=stride,
                           extent=(ext * stride,) * 3)
    np.testing.assert_array_equal(_np(pst.grid.coords),
                                  np.asarray(jst.grid.coords))
    return jst, pst


def _randomize(shapes, rng):
    """Random parameters and running statistics (variances positive) for
    a tree of arrays or of ``jax.eval_shape`` shapes."""
    def draw(path, x):
        a = rng.randn(*x.shape).astype(np.float32) * 0.3
        if str(path[-1].key) == "var":
            a = np.abs(a) + 0.5
        return jnp.asarray(a)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("interval,window", [(1, 16), (2, 16), (1, 50),
                                             (2, 7), (3, 5)])
def test_window_transformer_matches_jax(rng, interval, window):
    """Rows in (batch, Morton) order at stride 2, windows that straddle
    instances (attention stays within one), invalid rows after the valid
    ones, and padding to a multiple of window·interval."""
    jst, pst = _tensors(rng, stride=2)
    assert pst.capacity % (window * interval) != 0
    jm = jattn.MortonWindowTransformer(window_size=window, interval=interval)
    v = _randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jst), rng)
    assert set(v["params"]) == {"to_q", "to_kv", "to_out"}
    pm = mp.nn.attention.MortonWindowTransformer(8, window, interval,
                                                 device="cpu")
    load_flax(pm, v)
    ref = jax.jit(lambda v, x: jm.apply(v, x).features)(v, jst)
    with mp.nn.attention.record_attention() as routes:
        got = _np(pm(pst).features)
    assert [r.kind for r in routes] == ["window"]
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    valid = _np(pst.valid)
    assert (got[~valid] == 0).all()
    assert np.abs(got[valid] - _np(pst.features)[valid]).max() > 1e-3


@pytest.mark.parametrize("attn_max_len,kind", [(128, "window"),
                                               (2048, "full")])
def test_basic_block_window_or_full_matches_jax(rng, attn_max_len, kind):
    """The per-instance cell bound (12³ = 1728) decides at call time: above
    ``attn_max_len`` the window path (flax ``attentions/{to_q,…}``), else
    full attention (``attentions/SparseAttention_0/{to_q,…}``); both land
    on ``attentions.attn`` in the port."""
    jst, pst = _tensors(rng)
    assert pblocks._per_instance_cells(pst.grid) == 12 ** 3
    assert pblocks._per_instance_cells(pst.grid) == \
        jblocks._per_instance_cells(jst.grid)
    kw = dict(use_time_emb=True, group=4, with_attn=True,
              attn_max_len=attn_max_len, attn_window=16)
    jblk = jblocks.BasicBlock(8, **kw)
    pblk = pblocks.BasicBlock(8, temb_channels=16, device="cpu", **kw).eval()
    emb = rng.randn(3, 16).astype(np.float32)
    v = _randomize(jax.eval_shape(
        lambda k, x, e: jblk.init(k, x, e, None, train=False),
        jax.random.PRNGKey(0), jst, jnp.asarray(emb)), rng)
    flax_attn = set(v["params"]["attentions"])
    assert flax_attn == ({"to_q", "to_kv", "to_out"} if kind == "window"
                         else {"SparseAttention_0"})
    load_flax(pblk, v)
    ref = jax.jit(lambda v, x, e: jblk.apply(v, x, e, None, train=False)
                  .features)(v, jst, jnp.asarray(emb))
    with mp.nn.attention.record_attention() as routes:
        got = pblk(pst, _t(emb))
    assert [r.kind for r in routes] == [kind]
    np.testing.assert_allclose(_np(got.features), np.asarray(ref), **TOL)


def test_encoder_window_attn_matches_jax(rng):
    """`Encoder(with_window_attn=True, window_size=50)`: the window
    transformer runs after block3 on the stride-8 level (3 instances of up
    to 64 cells, so windows straddle instances), within 1e-4·max|ref|."""
    res, cap, b = 32, 2048, 3
    vox = [np.unique(rng.randint(0, res, (600, 3)), axis=0) for _ in range(b)]
    coords = mt.ops.batched_coordinates_np(vox)
    cpad, valid = mp.ops.pad_to_capacity(coords, cap)
    feats = valid[:, None].astype(np.float32)
    jst = jax.jit(lambda c, f, v: mt.sparse_tensor(
        c, f, capacity=cap, valid=v, batch_size=b, extent=(res,) * 3))(
        jnp.asarray(cpad), jnp.asarray(feats), jnp.asarray(valid))
    pst = mp.sparse_tensor(_t(cpad), _t(feats), capacity=cap, valid=_t(valid),
                           batch_size=b, extent=(res,) * 3)
    kw = dict(channels=(8, 16, 16, 16, 4),
              level_capacities=(1024, 512, 256, 256, 256),
              with_window_attn=True, window_size=50)
    jenc = mm.Encoder(**kw)
    penc = mp.models.vae.Encoder(device="cpu", **kw).eval()
    v = _randomize(jax.eval_shape(lambda k, x: jenc.init(k, x, train=False),
                                  jax.random.PRNGKey(0), jst), rng)
    assert set(v["params"]["window_attn"]) == {"to_q", "to_kv", "to_out"}
    load_flax(penc, v)
    jmean, jlv = jax.jit(lambda v, x: jenc.apply(v, x, train=False))(v, jst)
    with torch.no_grad(), mp.nn.attention.record_attention() as routes:
        pmean, plv = penc(pst)
    assert [r.kind for r in routes] == ["window"]
    np.testing.assert_array_equal(_np(pmean.grid.coords),
                                  np.asarray(jmean.grid.coords))
    for got, ref in ((pmean, jmean), (plv, jlv)):
        ref = np.asarray(ref.features)
        np.testing.assert_allclose(_np(got.features), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
