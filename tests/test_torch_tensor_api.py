"""The port's MinkowskiEngine-style tensor API against the JAX package, on
the CPU: ``TensorField`` (voxelize by avg and sum, splat, extent),
``slice_to_field``, ``cat_slice``, ``interpolate_at`` and `ops.interp`;
SparseTensor arithmetic (on one grid, and ``+`` across grids through the
union), ``dense``, ``to_sparse_dense``, ``dense_coordinates`` and the
``stack_*`` functions; ``ChannelwiseConv``; ``brick_applicable`` and
``brick_sparse_conv``; every activation of `nn.act` and its modules;
``set_algorithm``; ``capacity_report``; and the ``api_demo`` entry point.
Coordinates compare exactly, features at 1e-5 (activations 1e-6, convs
2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu.nn import act as jact
from mink_octtree_stablediffusion_tpu.ops import brick as jbrick
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch import api_demo
from mink_octtree_stablediffusion_tpu_torch.nn import act as pact
from mink_octtree_stablediffusion_tpu_torch.ops import brick as pbrick
from mink_octtree_stablediffusion_tpu_torch.utils.convert import load_flax

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
ACT_TOL = dict(rtol=1e-6, atol=1e-6)
CONV_TOL = dict(rtol=2e-5, atol=2e-5)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _t(a):
    return torch.as_tensor(np.array(a))


def _same_grid(jg, pg):
    np.testing.assert_array_equal(_np(pg.coords), np.asarray(jg.coords))
    np.testing.assert_array_equal(_np(pg.valid), np.asarray(jg.valid))
    assert pg.stride == jg.stride and pg.extent == jg.extent


def _fields(rng, m=300, batch=2, scale=12.0, cin=3, extent=None, lo=-6.0):
    """The same TensorField in both packages: continuous points in
    [lo, lo + scale) with a few invalid."""
    pts = np.concatenate([rng.randint(0, batch, (m, 1)),
                          rng.rand(m, 3) * scale + lo], 1).astype(np.float32)
    feats = rng.randn(m, cin).astype(np.float32)
    valid = rng.rand(m) > 0.1
    jf = mt.TensorField(jnp.asarray(pts), jnp.asarray(feats),
                        jnp.asarray(valid), batch_size=batch, extent=extent)
    pf = mp.TensorField(_t(pts), _t(feats), _t(valid), batch_size=batch,
                        extent=extent)
    return jf, pf


def _tensors(rng, n=150, cap=200, cin=4, batch=2, extent=None, lo=0, hi=12):
    c = np.concatenate([rng.randint(0, batch, (n, 1)),
                        rng.randint(lo, hi, (n, 3))], 1).astype(np.int32)
    f = rng.randn(n, cin).astype(np.float32)
    jst = jax.jit(lambda c, f: mt.sparse_tensor(
        c, f, cap, 1, batch, extent=extent))(jnp.asarray(c), jnp.asarray(f))
    pst = mp.sparse_tensor(_t(c), _t(f), cap, 1, batch, extent=extent)
    _same_grid(jst.grid, pst.grid)
    return jst, pst


@pytest.mark.parametrize("mode,stride,extent", [
    ("avg", 1, None), ("sum", 2, None), ("avg", 1, (16, 16, 16))])
def test_tensor_field_sparse_slice_matches_jax(rng, mode, stride, extent):
    """Voxelize (unbounded, or bounded with ``extent``), slice back to the
    points and concatenate each point's features with its voxel's."""
    lo = 0.0 if extent else -6.0
    jf, pf = _fields(rng, extent=extent, lo=lo)
    jst, jinv = jax.jit(lambda f: f.sparse(256, stride, mode))(jf)
    pst, pinv = pf.sparse(256, stride, mode)
    _same_grid(jst.grid, pst.grid)
    np.testing.assert_array_equal(_np(pinv), np.asarray(jinv))
    np.testing.assert_allclose(_np(pst.features), np.asarray(jst.features),
                               **TOL)
    for fn in ("slice_to_field", "cat_slice"):
        ref = jax.jit(getattr(mt, fn))(jst, jf, jinv)
        got = getattr(mp, fn)(pst, pf, pinv)
        np.testing.assert_allclose(_np(got.features),
                                   np.asarray(ref.features), **TOL)


def test_splat_interpolate_match_jax(rng):
    """``ops.interp``: the corner weights, the splat grid (unbounded) and
    features, and sampling at points by ``interpolate_at``, on the
    splat's grid and on a bounded grid with missing corners."""
    jf, pf = _fields(rng, m=120)
    for stride in (1, 2):
        jc, jw = mt.ops.interp.interpolation_weights(jf.coordinates, stride)
        pc, pw = mp.ops.interpolation_weights(pf.coordinates, stride)
        np.testing.assert_array_equal(_np(pc), np.asarray(jc))
        np.testing.assert_allclose(_np(pw), np.asarray(jw), **TOL)
    jst = jax.jit(lambda f: f.splat())(jf)
    pst = pf.splat()
    _same_grid(jst.grid, pst.grid)
    assert pst.grid.extent is None and pst.capacity == 120 * 8
    np.testing.assert_allclose(_np(pst.features), np.asarray(jst.features),
                               **TOL)
    jg = jax.jit(lambda f: mt.ops.splat_coordinates(
        f.coordinates, f.valid, 2, 400, 2))(jf)
    pg = mp.ops.splat_coordinates(pf.coordinates, pf.valid, 2, 400, 2)
    _same_grid(jg, pg)
    jb, pb = _tensors(rng, extent=(16,) * 3, cin=3)
    q = np.concatenate([rng.randint(0, 2, (90, 1)),
                        rng.rand(90, 3) * 14], 1).astype(np.float32)
    qv = rng.rand(90) > 0.1
    for js, ps in ((jst, pst), (jb, pb)):
        ref = jax.jit(mt.interpolate_at)(js, jnp.asarray(q), jnp.asarray(qv))
        got = mp.interpolate_at(ps, _t(q), _t(qv))
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def test_arithmetic_on_one_grid_and_across_grids(rng):
    """+, −, ·, / and negation on one grid (with scalars and tensors);
    across grids only +, through the union (unbounded here: JAX's rows in
    Morton order), the others a ValueError as in JAX."""
    ja, pa = _tensors(rng, lo=-6, hi=6)
    jb, pb = _tensors(rng, n=100, lo=-6, hi=6)
    jb2 = ja.with_features(ja.features * 2 + 1)
    pb2 = pa.with_features(pa.features * 2 + 1)
    ops = [lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
           lambda a, b: a / b, lambda a, b: -a, lambda a, b: a * 3.0,
           lambda a, b: a - 0.5]
    for op in ops:
        ref = op(ja, jb2)
        got = op(pa, pb2)
        assert got.grid is pa.grid
        np.testing.assert_allclose(_np(got.features),
                                   np.asarray(ref.features), **TOL)
    ref = jax.jit(lambda a, b: a + b)(ja, jb)
    got = pa + pb
    _same_grid(ref.grid, got.grid)
    np.testing.assert_allclose(_np(got.features), np.asarray(ref.features),
                               **TOL)
    for op in ops[1:4]:
        with pytest.raises(ValueError):
            op(pa, pb)


def test_dense_round_trip_matches_jax(rng):
    """``dense`` with and without ``min_coordinate`` (rows outside the
    shape dropped), ``to_sparse_dense`` (an unbounded grid, with a
    capacity overflow) and ``dense_coordinates``."""
    jst, pst = _tensors(rng, extent=(12,) * 3, cin=3)
    for shape, mins in (((12, 12, 12), None), ((8, 10, 12), (2, 1, 0))):
        ref = jax.jit(lambda s: s.dense(shape, mins))(jst)
        got = pst.dense(shape, mins)
        assert tuple(got.shape) == (2, 3) + shape
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    dense = np.asarray(jax.jit(lambda s: s.dense((12, 12, 12)))(jst))
    for cap in (256, 64):
        ref = jax.jit(lambda d: mt.to_sparse_dense(d, cap))(
            jnp.asarray(dense))
        got = mp.to_sparse_dense(_t(dense), cap)
        _same_grid(ref.grid, got.grid)
        np.testing.assert_allclose(_np(got.features),
                                   np.asarray(ref.features), **TOL)
    np.testing.assert_array_equal(
        _np(mp.dense_coordinates((3, 4, 2), 2)),
        np.asarray(mt.dense_coordinates((3, 4, 2), 2)))


def test_stack_reductions_match_jax(rng):
    ja, pa = _tensors(rng)
    js = [ja.with_features(ja.features * k + k) for k in (1.0, -2.0, 0.5)]
    ps = [pa.with_features(pa.features * k + k) for k in (1.0, -2.0, 0.5)]
    for fn in ("stack_sum", "stack_mean", "stack_var"):
        ref = getattr(mt, fn)(*js)
        got = getattr(mp, fn)(*ps)
        np.testing.assert_allclose(_np(got.features),
                                   np.asarray(ref.features), **TOL)
    _, pb = _tensors(rng)
    with pytest.raises(ValueError):
        mp.stack_sum(pa, pb)


def _carry(jm, args, module, rng, scale=0.3):
    """Random flax variables of ``jm``'s shapes (``eval_shape``: no JAX
    ``init`` compile), loaded into the port's ``module``."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    variables = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) *
                              scale), shapes)
    load_flax(module, variables)
    return variables


@pytest.mark.parametrize("stride,use_bias,extent", [
    (1, True, (12, 12, 12)), (2, False, None), (1, False, None)])
def test_channelwise_conv_matches_flax(rng, stride, use_bias, extent):
    """Per-channel kernel [K, C] over a kernel map, bounded (LUT lookups)
    and unbounded (sorted search), its [K, C] kernel carried 1:1."""
    jst, pst = _tensors(rng, cin=5, extent=extent)
    jm = mt.nn.ChannelwiseConv(3, stride, use_bias=use_bias, out_capacity=160)
    pm = mp.nn.ChannelwiseConv(5, 3, stride, use_bias=use_bias,
                               out_capacity=160, device="cpu")
    v = _carry(jm, (jst,), pm, rng)
    assert pm.kernel.shape == (27, 5)
    ref = jax.jit(lambda v, x: jm.apply(v, x))(v, jst)
    got = pm(pst)
    _same_grid(ref.grid, got.grid)
    np.testing.assert_allclose(_np(got.features), np.asarray(ref.features),
                               **CONV_TOL)


def test_brick_applicable_and_sparse_conv_match_jax(rng):
    jst, pst = _tensors(rng, n=400, cap=512, cin=4, extent=(16, 16, 16))
    specs = [dict(kernel_size=3), dict(kernel_size=3, stride=2),
             dict(kernel_size=2, stride=2, transpose=True),
             dict(kernel_size=3, dilation=2), dict(kernel_size=5),
             dict(kernel_size=3, region_type=mt.ops.RegionType.HYPER_CROSS)]
    for kw in specs:
        pkw = dict(kw)
        if "region_type" in kw:
            pkw["region_type"] = mp.ops.RegionType.HYPER_CROSS
        jspec = mt.ops.KernelSpec(ndim=3, **kw)
        pspec = mp.ops.KernelSpec(ndim=3, **pkw)
        assert pbrick.brick_applicable(pspec, pst.grid) == \
            jbrick.brick_applicable(jspec, jst.grid)
    spec = mp.ops.KernelSpec(3, ndim=3)
    assert pbrick.brick_applicable(spec, pst.grid)
    assert not pbrick.brick_applicable(spec, pst.grid, max_slots=7)
    unbounded = mp.SparseGrid(pst.grid.coords, pst.grid.valid, (1, 1, 1), 2)
    assert not pbrick.brick_applicable(spec, unbounded)
    k = (rng.randn(27, 4, 6) * 0.2).astype(np.float32)
    ref = jax.jit(mt.ops.brick_sparse_conv)(jst.features, jnp.asarray(k),
                                            jst.grid)
    got = mp.ops.brick_sparse_conv(pst.features, _t(k), pst.grid)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **CONV_TOL)
    # the same function as the gather-GEMM over the kernel map
    nbr = mp.ops.kernel_map(pst.grid, pst.grid, spec)
    np.testing.assert_allclose(
        _np(got), _np(mp.ops.sparse_conv_apply(pst.features, _t(k), nbr)),
        **CONV_TOL)


@pytest.mark.parametrize("name", sorted(jact._ACTS))
def test_activation_matches_jax(name):
    x = np.linspace(-8.0, 8.0, 64 * 9, dtype=np.float32).reshape(64, 9)
    x[0, :3] = (0.5, -0.5, 0.0)  # the shrink thresholds and 0
    ref = jact.get_act(name)(jnp.asarray(x))
    got = pact.get_act(name)(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **ACT_TOL)


def test_activation_functions_and_wrappers_match_jax(rng):
    assert set(pact._ACTS) == set(jact._ACTS)
    x = rng.randn(40, 6).astype(np.float32) * 2
    for fn, args in (("hardshrink", (0.3,)), ("softshrink", (1.2,)),
                     ("threshold", (0.1, -3.0))):
        np.testing.assert_allclose(
            _np(getattr(pact, fn)(_t(x), *args)),
            np.asarray(getattr(jact, fn)(jnp.asarray(x), *args)), **ACT_TOL)
    jst, pst = _tensors(rng, cin=6)
    for fn in ("relu", "elu", "silu", "gelu", "sigmoid", "tanh", "softmax"):
        ref = getattr(jact, fn)(jst)
        got = getattr(pact, fn)(pst)
        np.testing.assert_allclose(_np(got.features),
                                   np.asarray(ref.features), **ACT_TOL)
        assert got.grid is pst.grid
    got = pact.apply_fn(pst, lambda f: f + 1.0)
    assert not _np(got.features)[~_np(pst.valid)].any()


def test_activation_modules_match_jax(rng):
    """Sinusoidal, PReLU (shared and per channel) and
    AdaptiveLogSoftmaxWithLoss against flax with converted parameters;
    the random modules in eval mode against flax, and with a generator
    against their formula."""
    jst, pst = _tensors(rng, cin=6)
    for jm, pm in ((jact.Sinusoidal(5), pact.Sinusoidal(6, 5)),
                   (jact.PReLU(), pact.PReLU()),
                   (jact.PReLU(num_parameters=6), pact.PReLU(6))):
        v = _carry(jm, (jst,), pm, rng)
        ref = jax.jit(lambda v, x: jm.apply(v, x))(v, jst)
        np.testing.assert_allclose(_np(pm(pst).features),
                                   np.asarray(ref.features), **TOL)
    assert float(pact.PReLU().alpha.detach()) == 0.25
    target = rng.randint(0, 12, pst.capacity)
    jm = jact.AdaptiveLogSoftmaxWithLoss(6, 12, cutoffs=(4, 8))
    pm = pact.AdaptiveLogSoftmaxWithLoss(6, 12, cutoffs=(4, 8))
    v = _carry(jm, (jst, jnp.asarray(target)), pm, rng)
    ref = jax.jit(lambda v, x, t: jm.apply(v, x, t))(v, jst,
                                                     jnp.asarray(target))
    got = pm(pst, _t(target))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), **TOL)
    for jm, pm in ((jact.RReLU(), pact.RReLU()),
                   (jact.Dropout(0.3), pact.Dropout(0.3)),
                   (jact.AlphaDropout(0.3), pact.AlphaDropout(0.3))):
        ref = jm.apply({}, jst)
        np.testing.assert_allclose(_np(pm(pst).features),
                                   np.asarray(ref.features), **ACT_TOL)
    f = pst.features
    u = torch.rand(f.shape, generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    got = pact.RReLU(0.1, 0.3)(pst, deterministic=False, generator=gen)
    ref = torch.where(f >= 0, f, f * (0.1 + 0.2 * u))
    np.testing.assert_allclose(_np(got.features), _np(ref), **ACT_TOL)
    got = pact.Dropout(0.3)(pst, False, torch.Generator().manual_seed(5))
    ref = torch.where(u < 0.7, f / 0.7, 0.0) * pst.valid[:, None]
    np.testing.assert_allclose(_np(got.features), _np(ref), **ACT_TOL)
    got = pact.AlphaDropout(0.3)(pst, False, torch.Generator().manual_seed(5))
    alpha_p = -1.7580993408473766
    a = (0.7 + alpha_p ** 2 * 0.7 * 0.3) ** -0.5
    ref = (a * torch.where(u < 0.7, f, alpha_p) - a * alpha_p * 0.3) * \
        pst.valid[:, None]
    np.testing.assert_allclose(_np(got.features), _np(ref), **ACT_TOL)


def test_set_algorithm_matches_jax():
    """Each profile sets the same LUT ceiling and conv fusion threshold as
    the JAX package's, and moves the lookup route of a bounded grid."""
    grid = mp.SparseGrid(torch.zeros((4, 4), dtype=torch.int32),
                         torch.ones(4, dtype=torch.bool), (1, 1, 1), 2,
                         (64, 64, 64))
    try:
        for mode in mt.Algorithm:
            mt.set_algorithm(mode)
            mp.set_algorithm(mode.value)
            assert mp.get_algorithm().value == mt.get_algorithm().value
            assert mp.ops.lut.LUT_MAX_ENTRIES == mt.ops.lut.LUT_MAX_ENTRIES
            assert mp.ops.conv.DEFAULT_FUSED_THRESHOLD == \
                mt.ops.conv.DEFAULT_FUSED_THRESHOLD
            assert mp.ops.lookup_route(grid, torch.device("cpu")) == (
                "sorted" if mode == mt.Algorithm.MEMORY_EFFICIENT else "lut")
    finally:
        mt.set_algorithm(mt.Algorithm.DEFAULT)
        mp.set_algorithm(mp.Algorithm.DEFAULT)


def test_capacity_report_matches_jax(rng):
    jst, pst = _tensors(rng)
    assert mp.utils.capacity_report(pst, pst, names=["a", "b"]) == \
        mt.utils.capacity_report(jst, jst, names=["a", "b"])


def test_api_demo_prints_jax_counts(rng, capsys):
    """``python -m ...api_demo --device cpu`` with the example's convs'
    weights carried over prints the example's voxel counts: the JAX steps
    of `examples/api_demo.py` run here on the same weights."""
    r = np.random.RandomState(0)
    pts = r.rand(200, 3) * 16
    coords = mt.ops.batched_coordinates_np([mt.ops.sparse_quantize_np(pts,
                                                                      1.0)])
    cpad, valid = mt.ops.pad_to_capacity(coords, 256)
    st = jax.jit(lambda c, v: mt.sparse_tensor(
        c, jnp.ones((256, 1)) * v[:, None], capacity=256, valid=v,
        extent=(16,) * 3))(jnp.asarray(cpad), jnp.asarray(valid))
    convs = api_demo.build_convs(torch.device("cpu"))
    again = api_demo.build_convs(torch.device("cpu"))
    for name, m in convs.items():  # the weights come from the seed alone
        assert torch.equal(m.kernel, again[name].kernel)
    jconv = mt.nn.SparseConv(8, kernel_size=3)
    jdown = mt.nn.SparseConv(8, kernel_size=2, stride=2, out_capacity=64)
    jup = mt.nn.GenerativeConvTranspose(4, out_capacity=512)
    v1 = _carry(jconv, (st,), convs["conv"], rng)
    out = jax.jit(jconv.apply)(v1, st)
    v2 = _carry(jdown, (out,), convs["down"], rng)
    mid = jax.jit(jdown.apply)(v2, out)
    v3 = _carry(jup, (mid,), convs["up"], rng)
    grown = jax.jit(jup.apply)(v3, mid)
    pruned, _ = jax.jit(mt.ops.prune)(grown.grid, grown.features,
                                      grown.features[:, 0] > 0)
    field = mt.TensorField(
        jnp.asarray(np.concatenate([np.zeros((200, 1), np.float32),
                                    pts.astype(np.float32)], 1)),
        jnp.asarray(r.randn(200, 4).astype(np.float32)),
        jnp.ones((200,), bool))
    stf, _ = jax.jit(lambda f: f.sparse(capacity=256))(field)
    st2 = jax.jit(lambda s: mt.to_sparse_dense(s.dense((16, 16, 16)),
                                               capacity=256))(st)
    ref = {"input": st.count(), "strided": mid.count(),
           "grown": grown.count(), "pruned": pruned.count(),
           "field": stf.count(), "dense": st2.count()}
    got = api_demo.main(["--device", "cpu"], convs=convs)
    assert got == {k: int(v) for k, v in ref.items()}
    printed = capsys.readouterr().out
    assert f"pruned to {got['pruned']} voxels" in printed
    assert mt.utils.capacity_report(st, names=["input"]) in printed
    assert printed.rstrip().endswith("API demo OK")
