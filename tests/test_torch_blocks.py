"""The port's norms, attention and residual blocks against the JAX package.

Each flax module is initialised, its parameters are randomised, carried
over with ``utils.convert.from_flax`` (one-to-one cover checked) and the
same numpy inputs go through both; float32 throughout, compared at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu.nn import blocks as jblocks
from mink_octtree_stablediffusion_tpu_torch.nn import blocks as pblocks
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (from_flax,
                                                                  load_flax)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _tensors(rng, cap=512, cin=8, ext=12, bsz=3, n=250, empty_instance=None):
    """The same sparse tensor in both packages; ``empty_instance`` gets no
    voxels (its attention keys are all masked)."""
    coords = []
    for b in range(bsz):
        if b == empty_instance:
            continue
        c = np.unique(rng.randint(0, ext, (n, 3)), axis=0)
        coords.append(np.concatenate([np.full((len(c), 1), b, np.int32), c],
                                     1))
    coords = np.concatenate(coords).astype(np.int32)
    cpad, valid = mp.ops.pad_to_capacity(coords, cap)
    feats = (rng.randn(cap, cin) * valid[:, None]).astype(np.float32)
    jst = jax.jit(lambda c, f, v: mt.sparse_tensor(
        c, f, capacity=cap, valid=v, batch_size=bsz, extent=(ext,) * 3))(
        jnp.asarray(cpad), jnp.asarray(feats), jnp.asarray(valid))
    pst = mp.sparse_tensor(_t(cpad), _t(feats), capacity=cap, valid=_t(valid),
                           batch_size=bsz, extent=(ext,) * 3)
    return jst, pst


def _randomize(variables, rng):
    """Random parameters and running statistics (variances positive)."""
    def draw(path, x):
        a = rng.randn(*np.shape(x)).astype(np.float32) * 0.3
        if str(path[-1].key) == "var":
            a = np.abs(a) + 0.5
        return jnp.asarray(a)
    return jax.tree_util.tree_map_with_path(draw, variables)


def _carry(flax_module, variables, port_module, rng):
    variables = _randomize(variables, rng)
    load_flax(port_module, variables)
    return variables


def test_norms_match_jax(rng):
    jst, pst = _tensors(rng, empty_instance=1)
    jbn = mt.nn.BatchNorm()
    v = _carry(jbn, jbn.init(jax.random.PRNGKey(0), jst, train=False),
               pbn := mp.nn.BatchNorm(8, device="cpu").eval(), rng)
    ref = jax.jit(lambda v, x: jbn.apply(v, x, train=False).features)(v, jst)
    np.testing.assert_allclose(_np(pbn(pst).features), np.asarray(ref), **TOL)
    for group in (1, 4, 32):
        jin = mt.nn.StableInstanceNorm(group=group)
        pin = mp.nn.StableInstanceNorm(8, group=group, device="cpu")
        v = _carry(jin, jin.init(jax.random.PRNGKey(0), jst), pin, rng)
        ref = jax.jit(lambda v, x: jin.apply(v, x).features)(v, jst)
        np.testing.assert_allclose(_np(pin(pst).features), np.asarray(ref),
                                   **TOL)


def test_attention_matches_jax_with_masked_instance(rng):
    """Instance 1 has no voxels: all its keys are masked, its queries get
    zero weights (finite output), exactly as in JAX."""
    jst, pst = _tensors(rng, empty_instance=1)
    jtr = mt.nn.SparseTransformer(max_len=200)
    ptr = mp.nn.SparseTransformer(8, max_len=200, device="cpu")
    v = _carry(jtr, jtr.init(jax.random.PRNGKey(0), jst), ptr, rng)
    ref = jax.jit(lambda v, x: jtr.apply(v, x).features)(v, jst)
    got = _np(ptr(pst).features)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    # the core alone: an all-masked row gives zeros, not NaN
    q = torch.randn(2, 4, 8)
    mask = torch.tensor([[True, True, False, False], [False] * 4])
    out = mp.nn.attention._mha(q, q, q, mask, 2)
    ref = mt.nn.attention._mha(*(jnp.asarray(q.numpy()),) * 3,
                               jnp.asarray(mask.numpy()), 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert np.all(out[1].numpy() == 0)


@pytest.mark.parametrize("kind", ["time_emb_attn", "scale_shift", "batch"])
def test_basic_block_matches_jax(rng, kind):
    jst, pst = _tensors(rng)
    use_emb = kind != "batch"
    kw = dict(use_time_emb=use_emb, group=4, with_attn=kind != "batch",
              attn_max_len=128,
              time_embedding_norm="scale_shift" if kind == "scale_shift"
              else "default")
    jblk = jblocks.BasicBlock(8, **kw)
    pblk = pblocks.BasicBlock(8, temb_channels=16, device="cpu", **kw).eval()
    emb = rng.randn(3, 16).astype(np.float32) if use_emb else None
    jemb = None if emb is None else jnp.asarray(emb)
    v = _carry(jblk, jblk.init(jax.random.PRNGKey(0), jst, jemb, None,
                               train=False), pblk, rng)
    ref = jax.jit(lambda v, x, e: jblk.apply(v, x, e, None, train=False)
                  .features)(v, jst, jemb)
    got = pblk(pst, None if emb is None else _t(emb))
    np.testing.assert_allclose(_np(got.features), np.asarray(ref), **TOL)


@pytest.mark.parametrize("after", ["downsample", "upsample",
                                   "upsample_determine"])
def test_resnet_stack_matches_jax(rng, after):
    """Conv heads (strided, generative, pinned transpose) with the
    routing of the conv branches: fused (plain on the CPU) and dense."""
    jst, pst = _tensors(rng, cin=6)
    use_emb = after == "upsample"
    emb = rng.randn(3, 16).astype(np.float32)
    jx, px, jpin, ppin, cap = jst, pst, None, None, 256
    if after != "downsample":  # start one level coarser, pin to the fine grid
        jx = jax.jit(lambda t: mt.nn.conv.SparseConv(
            6, 3, 2, out_capacity=256).apply(
            {"params": {"kernel": jnp.ones((27, 6, 6)) * 0.05}}, t))(jst)
        px = mp.SparseTensor(
            grid=mp.ops.stride_grid(pst.grid, 2, 256),
            features=_t(np.asarray(jx.features)))
        np.testing.assert_array_equal(_np(px.grid.coords),
                                      np.asarray(jx.grid.coords))
        jpin, ppin, cap = jst.grid, pst.grid, 4096
    kw = dict(layers=3 if use_emb else 2, after=after, use_time_emb=use_emb,
              group=2, out_capacity=cap)
    jstk = jblocks.ResNetStack(10, **kw)
    pstk = pblocks.ResNetStack(6, 10, temb_channels=16, device="cpu",
                               **kw).eval()
    jemb = jnp.asarray(emb) if use_emb else None
    v = _carry(jstk, jstk.init(jax.random.PRNGKey(0), jx, jemb, jpin, None,
                               train=False), pstk, rng)
    ref = jax.jit(lambda v, x, e, g: jstk.apply(v, x, e, g, None,
                                                train=False))(v, jx, jemb,
                                                              jpin)
    with mp.nn.record_routes() as routes:
        got = pstk(px, _t(emb) if use_emb else None, out_grid=ppin)
    np.testing.assert_array_equal(_np(got.grid.coords),
                                  np.asarray(ref.grid.coords))
    np.testing.assert_allclose(_np(got.features), np.asarray(ref.features),
                               **TOL)
    assert "fused" in {r.branch for r in routes}


def test_from_flax_cover_is_one_to_one(rng):
    jst, pst = _tensors(rng)
    jblk = jblocks.BasicBlock(8, use_time_emb=True, group=4, with_attn=True)
    v = jblk.init(jax.random.PRNGKey(0), jst, jnp.zeros((3, 16)), None,
                  train=False)
    pblk = pblocks.BasicBlock(8, use_time_emb=True, temb_channels=16,
                              group=4, with_attn=True, device="cpu")
    sd = from_flax(v, pblk)
    # a Dense [in, out] kernel lands transposed on a Linear [out, in]
    np.testing.assert_array_equal(
        sd["time_emb_proj.weight"].numpy(),
        np.asarray(v["params"]["time_emb_proj"]["kernel"]).T)
    params = jax.tree_util.tree_map(lambda x: x, v["params"])
    params = dict(params)
    del params["conv2"]
    with pytest.raises(KeyError, match="never set"):
        from_flax({"params": params}, pblk)
    extra = dict(v["params"], extra_conv={"kernel": np.zeros((27, 8, 8))})
    with pytest.raises(KeyError, match="unused"):
        from_flax({"params": extra}, pblk)
