"""The port's convs given a kernel map against the JAX package: B4
(``onehot_sparse_conv``) and its ``onehot_conv`` backward, B7
(``pallas_sparse_conv``), the room pipeline of `bench.py`, the nn convs'
map route (``use_onehot_conv(False)``), and B1 cut into stages (B8/B9,
``fused_conv_stage``).

On the CPU every wrapper takes its plain version and launches nothing.
The JAX side runs as `tests/test_pallas.py` runs it: its Pallas kernels in
interpret mode with ``compute_dtype=float32``.  Tolerances: 2e-5 for the
forwards (float32, summation order only), 1e-5 of max|ref| for the
backward, exact for coordinates and maps.  The kernels themselves run
only on the card (`tests/test_torch_cuda.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu.ops import onehot_conv as joh
from mink_octtree_stablediffusion_tpu.ops.pallas_conv import (
    pallas_sparse_conv as jax_pallas_sparse_conv)
from mink_octtree_stablediffusion_tpu_torch import bench_conv
from mink_octtree_stablediffusion_tpu_torch.ops import (fused_conv,
                                                        onehot_conv,
                                                        pallas_conv)

torch.set_num_threads(1)
F32 = dict(rtol=2e-5, atol=2e-5)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _launches():
    return (onehot_conv.onehot_sparse_conv.launches,
            pallas_conv.pallas_sparse_conv.launches,
            fused_conv.fused_conv_stage.launches)


class _Case:
    """One conv given a map in both packages: the features on the grid's
    rows, the kernel, JAX's map (numpy) and the grids."""

    def __init__(self, coords, cap, cin, cout, extent, batch, rng):
        cpad, valid = mp.ops.pad_to_capacity(coords, cap)
        self.kernel = (rng.randn(27, cin, cout) * 0.1).astype(np.float32)
        pf = (rng.randn(cap, cin) * valid[:, None]).astype(np.float32)
        self.raw = (cpad, valid, pf)
        self.spec = mt.ops.KernelSpec(3, 1, ndim=3)
        self.pspec = mp.ops.KernelSpec(3, 1, ndim=3)

        def jax_side(c, v, f):
            grid, inv, _ = mt.ops.make_grid(c, v, cap, batch_size=batch,
                                            extent=extent)
            f = mt.ops.reduce_by_inverse(f, inv, v, cap, "sum")
            return grid, f, mt.ops.kernel_map(grid, grid, self.spec)
        self.jgrid, jf, jnbr = jax.jit(jax_side)(*map(jnp.asarray, self.raw))
        self.features, self.nbr = np.asarray(jf), np.asarray(jnbr)
        grid, inv, _ = mp.ops.make_grid(_t(cpad), _t(valid), cap,
                                        batch_size=batch, extent=extent)
        self.pgrid = grid
        self.pfeatures = mp.ops.reduce_by_inverse(_t(pf), inv, _t(valid), cap,
                                                  "sum")
        self.pnbr = mp.ops.kernel_map(grid, grid, self.pspec)


@pytest.fixture(scope="module")
def room():
    """`bench.py`'s room cut to 2,000 points (capacity 2,048), 3→32."""
    rng = np.random.RandomState(0)
    n = 2000
    coords = np.concatenate([np.zeros((n, 1), np.int32),
                             bench_conv.scannet_like_cloud(rng, n)], 1)
    return _Case(coords, 2048, 3, 32, bench_conv.ROOM_EXTENT, 1, rng)


@pytest.fixture(scope="module")
def small():
    """`tests/test_pallas.py::test_pallas_conv_matches_xla`'s shape: 100
    points in 8³, capacity 256, 8→16."""
    rng = np.random.RandomState(0)
    coords = np.concatenate([np.zeros((100, 1), np.int32),
                             rng.randint(0, 8, (100, 3))], 1).astype(np.int32)
    return _Case(coords, 256, 8, 16, (8, 8, 8), 1, rng)


def _shuffled(nbr, rng):
    """The map's columns shuffled, then a tenth of them replaced by copies
    of others (many outputs reading one input row)."""
    out = nbr[:, rng.permutation(nbr.shape[1])]
    dst = rng.choice(nbr.shape[1], nbr.shape[1] // 10, replace=False)
    out[:, dst] = out[:, rng.choice(nbr.shape[1], len(dst))]
    return out


@pytest.mark.parametrize("case,tw", [("small", 128), ("room", 512),
                                     ("room_shuffled", 512)])
def test_onehot_plain_matches_jax(request, case, tw):
    """B4's plain version against JAX's kernel (interpret mode, float32)
    on the same map; JAX's kernel is exact for any map, so also for a
    shuffled map with duplicated columns."""
    c = request.getfixturevalue(case.split("_")[0])
    nbr = c.nbr
    if case.endswith("shuffled"):
        nbr = _shuffled(nbr, np.random.RandomState(1))
    ref = joh.onehot_sparse_conv(
        jnp.asarray(c.features), jnp.asarray(c.kernel), jnp.asarray(nbr),
        tile=128, tw=tw, compute_dtype=jnp.float32, interpret=True)
    before = _launches()
    got = mp.ops.onehot_sparse_conv(_t(c.features), _t(c.kernel), _t(nbr),
                                    compute_dtype=torch.float32)
    assert _launches() == before  # the CPU launches no kernel
    np.testing.assert_allclose(_np(got), np.asarray(ref), **F32)


def test_pallas_plain_matches_jax(small):
    """B7's plain version against JAX's kernel (interpret mode, float32:
    B7 computes in the features' dtype)."""
    ref = jax_pallas_sparse_conv(jnp.asarray(small.features),
                                 jnp.asarray(small.kernel),
                                 jnp.asarray(small.nbr), tile=128,
                                 interpret=True)
    got = pallas_conv.pallas_sparse_conv(_t(small.features), _t(small.kernel),
                                         _t(small.nbr), tile=128)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(ref), **F32)


def test_pallas_raises_where_jax_asserts(small):
    """``N_out % tile != 0`` fails in both packages."""
    nbr = small.nbr[:, :200]
    with pytest.raises(AssertionError):
        jax_pallas_sparse_conv(jnp.asarray(small.features),
                               jnp.asarray(small.kernel), jnp.asarray(nbr),
                               tile=128, interpret=True)
    with pytest.raises(ValueError):
        pallas_conv.pallas_sparse_conv(_t(small.features), _t(small.kernel),
                                       _t(nbr), tile=128)


def _tf32(x):
    """``x`` rounded to nearest at TF32's 10-bit mantissa."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("case", ["small", "room"])
def test_b7_f32_limit_rejects_tf32_rounding(request, case):
    """The limit that holds B7 on float32 features to its float32 plain
    version on the card (`chip_smoke.py`'s ``B7_F32_RTOL``, the card
    test's ``_close_f32``: 2e-5·max|ref|) lies above the float32 plain
    version's own error against a float64 sum and below the error of the
    same sum on TF32-rounded operands, so a B7 that rounded to TF32 fails
    it."""
    c = request.getfixturevalue(case)
    f, k, nbr = _t(c.features), _t(c.kernel), _t(c.nbr)
    hit = nbr >= 0
    exact = sum(torch.where(hit[kk, :, None],
                            f.double()[nbr[kk].clamp(min=0).long()], 0.0)
                @ k.double()[kk] for kk in range(nbr.shape[0]))
    lim = 2e-5 * exact.abs().max().item()
    f32 = onehot_conv.map_conv_plain(f, k, nbr, torch.float32)
    tf32 = onehot_conv.map_conv_plain(_tf32(f), _tf32(k), nbr, torch.float32)
    assert (f32.double() - exact).abs().max().item() <= lim / 10
    assert (tf32.double() - exact).abs().max().item() > 2 * lim


def _exact(f, k, nbr):
    """The conv along ``nbr`` in float64 from the given operands."""
    hit = nbr >= 0
    return sum(torch.where(hit[kk, :, None],
                           f.double()[nbr[kk].clamp(min=0).long()], 0.0)
               @ k.double()[kk] for kk in range(nbr.shape[0]))


@pytest.mark.parametrize("case", ["small", "room"])
def test_b7_split_product_within_f32_limit(request, case):
    """B7's card kernel forms float32-accurate products from bf16 split
    terms (`csrc/map_conv.cuh`): on float32 features the 6 products of
    three terms each with i + j ≤ 2.  Emulated here
    (``_map_conv_pairs_plain``: exact term products, float32 sums in the
    kernel's order), that stays within the float32 limit (2e-5·max|ref|,
    ``B7_F32_RTOL``) of a float64 sum, where one bf16 product, terms (1,
    1), does not; bf16 features times the weight's three terms, (1, 3),
    stay within it of the float64 sum on the bf16 features."""
    c = request.getfixturevalue(case)
    f, k, nbr = _t(c.features), _t(c.kernel), _t(c.nbr)
    k_all = nbr.shape[0]
    exact = _exact(f, k, nbr)
    lim = 2e-5 * exact.abs().max().item()
    six = onehot_conv._map_conv_pairs_plain(f, k, nbr, (3, 3), k_all)
    one = onehot_conv._map_conv_pairs_plain(f, k, nbr, (1, 1), k_all)
    assert (six.double() - exact).abs().max().item() <= lim / 10
    assert (one.double() - exact).abs().max().item() > 2 * lim
    fb = f.bfloat16()
    exact_b = _exact(fb.float(), k, nbr)
    three = onehot_conv._map_conv_pairs_plain(fb.float(), k, nbr, (1, 3),
                                              k_all)
    assert (three.double() - exact_b).abs().max().item() <= \
        2e-6 * exact_b.abs().max().item()


def test_b7_bf16_features_take_the_float32_weight():
    """B7 on bf16 features multiplies them by the float32 weight, as JAX's
    kernel does (its body takes ``w_ref`` as given, and only the output is
    rounded to bf16): features 1 and W = [1 + 3·2⁻¹⁰, −1] give the exact
    sum 3·2⁻¹⁰ in both packages, where a bf16-rounded weight gives 0."""
    f = np.ones((8, 2), np.float32)
    w = np.array([[[1 + 3 * 2.0 ** -10], [-1.0]]], np.float32)
    nbr = np.arange(8, dtype=np.int32)[None]
    ref = jax_pallas_sparse_conv(jnp.asarray(f, jnp.bfloat16),
                                 jnp.asarray(w), jnp.asarray(nbr), tile=8,
                                 interpret=True)
    got = pallas_conv.pallas_sparse_conv(_t(f).bfloat16(), _t(w), _t(nbr),
                                         tile=8)
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got.float()),
                                  np.asarray(ref.astype(jnp.float32)))
    assert torch.all(got.float() == 3 * 2.0 ** -10)


def test_b7_bf16_features_match_jax(small):
    """B7 on bf16 features against JAX's kernel (interpret mode) on the
    same bf16 features and float32 weight: the two float32 sums may round
    to neighbouring bf16 values, so one bf16 ulp of max|ref|,
    2^(⌊log₂ max|ref|⌋ − 7), + 1e-5."""
    ref = np.asarray(jax_pallas_sparse_conv(
        jnp.asarray(small.features, jnp.bfloat16), jnp.asarray(small.kernel),
        jnp.asarray(small.nbr), tile=128, interpret=True
    ).astype(jnp.float32))
    got = pallas_conv.pallas_sparse_conv(
        _t(small.features).bfloat16(), _t(small.kernel), _t(small.nbr),
        tile=128)
    assert got.dtype == torch.bfloat16
    ref_max = np.abs(ref).max()
    ulp = 2.0 ** (np.floor(np.log2(ref_max)) - 7)
    assert np.abs(_np(got.float()) - ref).max() <= ulp + 1e-5


@pytest.mark.parametrize("case", ["small", "room"])
def test_onehot_conv_backward_matches_jax(request, case):
    """``onehot_conv``'s backward (plain PyTorch on both devices) against
    JAX's ``_xla_backward`` called directly and against ``jax.grad`` of
    ``sparse_conv_apply``, within 1e-5 of max|ref| (dW sums ~2,000 rows
    of magnitude ~10 on the room, where JAX's two formulas differ from
    each other by 5.5e-7 of max|ref|); ``nbr_idx`` gets no gradient."""
    c = request.getfixturevalue(case)
    g = np.random.RandomState(2).randn(c.nbr.shape[1],
                                       c.kernel.shape[2]).astype(np.float32)
    jf, jk, jn, jg = map(jnp.asarray, (c.features, c.kernel, c.nbr, g))
    ref = joh._xla_backward(jf, jk, jn, jg)
    ref_ad = jax.grad(lambda f, k: jnp.vdot(
        mt.ops.sparse_conv_apply(f, k, jn), jg), argnums=(0, 1))(jf, jk)
    f = _t(c.features).requires_grad_()
    k = _t(c.kernel).requires_grad_()
    nbr = _t(c.nbr)
    out = onehot_conv.onehot_conv(f, k, nbr)
    got = torch.autograd.grad((out * _t(g)).sum(), (f, k))
    assert not nbr.requires_grad
    for a, b, d in zip(got, ref, ref_ad):
        for r in (np.asarray(b), np.asarray(d)):
            np.testing.assert_allclose(_np(a), r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max())


def test_room_pipeline_matches_jax(room):
    """``pad_to_capacity`` → ``make_grid`` → ``reduce_by_inverse`` →
    ``kernel_map`` → ``onehot_sparse_conv`` against the same JAX calls:
    coordinates and map exactly, the conv to 2e-5."""
    np.testing.assert_array_equal(_np(room.pgrid.coords),
                                  np.asarray(room.jgrid.coords))
    np.testing.assert_array_equal(_np(room.pgrid.valid),
                                  np.asarray(room.jgrid.valid))
    np.testing.assert_array_equal(_np(room.pnbr), room.nbr)
    np.testing.assert_allclose(_np(room.pfeatures), room.features, **F32)
    ref = jax.jit(mt.ops.sparse_conv_apply)(
        jnp.asarray(room.features), jnp.asarray(room.kernel),
        jnp.asarray(room.nbr))
    got = mp.ops.onehot_sparse_conv(room.pfeatures, _t(room.kernel),
                                    room.pnbr, compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **F32)


def test_use_onehot_conv_false_takes_the_map_route(room):
    """With ``use_onehot_conv(False)`` a bounded-grid ``SparseConv`` takes
    ``kernel_map`` + ``sparse_conv_apply`` (route ``"plain"``), with
    ``None`` the fused route; both give the same output."""
    conv = mp.nn.SparseConv(3, 32, kernel_size=3, device="cpu")
    with torch.no_grad():
        conv.kernel.copy_(_t(room.kernel))
    x = mp.SparseTensor(grid=room.pgrid, features=room.pfeatures)
    outs = {}
    try:
        for flag in (False, None):
            mp.ops.use_onehot_conv(flag)
            with mp.nn.record_routes() as routes:
                outs[flag] = conv(x).features
            assert [r.branch for r in routes] == [
                "plain" if flag is False else "fused"]
    finally:
        mp.ops.use_onehot_conv(None)
    assert onehot_conv.enabled(room.pgrid)
    np.testing.assert_allclose(_np(outs[False]), _np(outs[None]), **F32)


@pytest.mark.parametrize("stage", ["full", "search", "gather", "empty"])
def test_b1_stage_plain_versions(room, stage):
    """Each stage of ``fused_conv_stage`` on the room (float32): ``full``
    against JAX's ``fused_sparse_conv`` with the attribution scripts'
    group 9, tile 128 and tw 256 (interpret mode); ``search`` against the
    per-row count of ``kernel_map >= 0``; ``gather`` against
    ``sparse_conv_apply`` with identity weights; ``empty`` zeros."""
    before = _launches()
    got = _np(fused_conv.fused_conv_stage(room.pfeatures, _t(room.kernel),
                                          room.pgrid, room.pgrid, room.pspec,
                                          stage, torch.float32))
    assert _launches() == before
    assert got.shape == (room.nbr.shape[1], 32)
    if stage == "full":
        ref = mt.ops.fused_sparse_conv(
            jnp.asarray(room.features), jnp.asarray(room.kernel), room.jgrid,
            room.jgrid, room.spec, group=9, tile=128, tw=256,
            compute_dtype=jnp.float32, interpret=True)
    elif stage == "search":
        ref = np.zeros_like(got)
        ref[:, 0] = (room.nbr >= 0).sum(0)
    elif stage == "gather":
        eye = np.broadcast_to(np.eye(3, 32, dtype=np.float32), (27, 3, 32))
        ref = jax.jit(mt.ops.sparse_conv_apply)(
            jnp.asarray(room.features), jnp.asarray(eye),
            jnp.asarray(room.nbr))
    else:
        ref = np.zeros_like(got)
    np.testing.assert_allclose(got, np.asarray(ref), **F32)
