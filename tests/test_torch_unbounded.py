"""The port's unbounded grids against the JAX package, on the CPU.

Unbounded grids (``extent=None``, and bounded ones of 2³⁰ cells or more)
sort by (batch, Morton) with the coordinates as tie-breakers, and are
queried through the hash table (`ops.hashtable`, the route on CUDA
tensors) or the sorted search (`ops.search`, the route on the CPU).  The
same numpy inputs go through both packages; coordinates, hash slots,
lookups, maps and row order are compared exactly, features at 1e-6 and
convs at 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import diffusion as md
from mink_octtree_stablediffusion_tpu.ops import hashtable as jhash
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.ops import hashtable as phash
from mink_octtree_stablediffusion_tpu_torch.utils.convert import load_flax

torch.set_num_threads(1)
CONV_TOL = dict(rtol=2e-5, atol=2e-5)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _t(a):
    return torch.as_tensor(np.array(a))


def _coords(rng, n, batch=3, lo=-40, hi=40, d=3, dup=0):
    """Batched int32 coords in [lo, hi), ``dup`` of them repeated."""
    c = np.concatenate([rng.randint(0, batch, (n, 1)),
                        rng.randint(lo, hi, (n, d))], 1).astype(np.int32)
    return np.concatenate([c, c[:dup]]) if dup else c


def _padded(rng, coords, invalid=0.1):
    valid = rng.rand(len(coords)) > invalid
    c = coords.copy()
    c[~valid] = mt.ops.INVALID_COORD
    return c, valid


def _same_grid(jg, pg):
    np.testing.assert_array_equal(_np(pg.coords), np.asarray(jg.coords))
    np.testing.assert_array_equal(_np(pg.valid), np.asarray(jg.valid))
    assert pg.stride == jg.stride and pg.extent == jg.extent
    assert pg.batch_size == jg.batch_size


def _grids(coords, valid, cap, stride=1, bsz=3, extent=None):
    jg, _, _ = jax.jit(lambda c, v: mt.ops.make_grid(
        c, v, cap, stride, bsz, extent=extent))(jnp.asarray(coords),
                                                jnp.asarray(valid))
    pg, _, _ = mp.ops.make_grid(_t(coords), _t(valid), cap, stride, bsz,
                                extent=extent)
    return jg, pg


@pytest.mark.parametrize("d,span", [(3, 1 << 15), (2, 1 << 20)])
def test_pack_keys_and_hash_match_jax(rng, d, span):
    """Negative coordinates and the field edges; D=2's 21-bit fields
    straddle the 32-bit lane boundary."""
    c = _coords(rng, 600, batch=7, lo=-span, hi=span, d=d)
    c[:4, 1:] = [[-span] * d, [span - 1] * d, [0] * d, [-1] * d]
    jhi, jlo = jhash.pack_keys(jnp.asarray(c))
    phi, plo = phash.pack_keys(_t(c))
    np.testing.assert_array_equal(_np(phi), np.asarray(jhi, np.int64))
    np.testing.assert_array_equal(_np(plo), np.asarray(jlo, np.int64))
    np.testing.assert_array_equal(_np(phash._hash(phi, plo)),
                                  np.asarray(jhash._hash(jhi, jlo), np.int64))
    if d == 2:  # field 1 starts at bit 21 and spills into the high lane
        assert np.any(np.asarray(jhi) & ((1 << 10) - 1))


@pytest.mark.parametrize("d,table_size", [(3, None), (2, 1024), (3, 512)])
def test_build_table_and_lookup_match_jax(rng, d, table_size):
    """``slots`` bit for bit (a 512-slot table at ~50% load makes long
    probe runs) and lookups with misses and invalid queries."""
    c = np.unique(_coords(rng, 400, d=d, lo=-300, hi=300), axis=0)[:250]
    c, valid = _padded(rng, c)
    jt = jax.jit(lambda c, v: jhash.build_table(c, v, table_size))(
        jnp.asarray(c), jnp.asarray(valid))
    pt = phash.build_table(_t(c), _t(valid), table_size)
    np.testing.assert_array_equal(_np(pt.slots), np.asarray(jt.slots))
    assert pt.rounds >= 2
    q = np.concatenate([c, c + 1, c[::-1]])
    q[:, 0] = np.where(np.arange(len(q)) % 5 == 0, 9, q[:, 0])
    qv = rng.rand(len(q)) > 0.1
    ref = jax.jit(jhash.lookup)(jt, jnp.asarray(q), jnp.asarray(qv))
    got, rounds, probes = phash.probe(pt, _t(q), _t(qv))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    assert int(probes.max()) == rounds and int(probes[~_t(qv)].sum()) == 0
    assert 0 < int((got >= 0).sum()) < int(_t(qv).sum())


@pytest.mark.parametrize("stride,cap,dup", [(1, 600, 60), (2, 600, 0),
                                            (1, 200, 30)])
def test_unique_coords_unbounded_matches_jax(rng, stride, cap, dup):
    """Morton-order dedup with invalid rows, duplicates and (cap 200) an
    overflow: coords, valid, inverse and count; then ``make_grid``."""
    c = _coords(rng, 500, dup=dup) * stride
    c, valid = _padded(rng, c)
    ref = jax.jit(lambda c, v: mt.ops.unique_coords(c, v, cap, stride))(
        jnp.asarray(c), jnp.asarray(valid))
    got = mp.ops.unique_coords(_t(c), _t(valid), cap, stride)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_np(g), np.asarray(r))
    if cap == 200:
        assert int(got[3]) > cap
    jg, pg = _grids(c, valid, cap, stride)
    _same_grid(jg, pg)


def test_canonical_order_with_morton_ties(rng):
    """Beyond ±512 cells Morton codes clip and tie; the coordinates break
    the ties, last column first, as JAX's ``lexsort``."""
    c = _coords(rng, 400, batch=2, lo=-3000, hi=3000)
    c[:100, 1] = rng.choice([-2000, 2000], 100)  # many rows per clipped code
    c, valid = _padded(rng, c)
    ref = jax.jit(lambda c, v: mt.ops.canonical_order(c, v, 1))(
        jnp.asarray(c), jnp.asarray(valid))
    got = mp.ops.canonical_order(_t(c), _t(valid), 1)
    np.testing.assert_array_equal(c[_np(got)], c[np.asarray(ref)])
    codes = mt.ops.morton_encode_np(c[valid][:, 1:])
    assert len(np.unique(codes)) < valid.sum()
    jg, pg = _grids(c, valid, 450, bsz=2)
    _same_grid(jg, pg)


def test_stride_and_expand_unbounded_match_jax(rng):
    """Floor-rounded coarsening of negative coordinates, the k3 expansion
    (unbounded) and the k2-s2 octree growth."""
    c, valid = _padded(rng, _coords(rng, 300))
    jg, pg = _grids(c, valid, 320)
    js = jax.jit(lambda g: mt.ops.stride_grid(g, 2, 256))(jg)
    ps = mp.ops.stride_grid(pg, 2, 256)
    _same_grid(js, ps)
    assert (_np(ps.coords)[_np(ps.valid)][:, 1:] < 0).any()
    for spec, grid, jgrid, cap in (
            (dict(kernel_size=3), ps, js, 2048),
            (dict(kernel_size=2, stride=2, transpose=True), ps, js, 1024)):
        jspec = mt.ops.KernelSpec(ndim=3, **spec)
        pspec = mp.ops.KernelSpec(ndim=3, **spec)
        offs = jspec.absolute_offsets(jgrid.stride)
        out_stride = jspec.out_stride(jgrid.stride)
        je = jax.jit(lambda g: mt.ops.expand_grid(g, offs, out_stride, cap))(
            jgrid)
        pe = mp.ops.expand_grid(grid, pspec.absolute_offsets(grid.stride),
                                pspec.out_stride(grid.stride), cap)
        _same_grid(je, pe)


def test_lookup_sorted_unbounded_and_duplicate_window(rng):
    """The (batch, Morton) search, and the reference's misses: a run of
    more than ``_DUP_WINDOW`` rows on one clipped code hides the rows past
    the window (ROADMAP.md §C)."""
    c = _coords(rng, 200, batch=2)
    run = np.array([[0, 600 + i, 600, 600] for i in range(8)], np.int32)
    c = np.concatenate([c, run])
    c, valid = _padded(rng, c, invalid=0.05)
    valid[-8:] = True
    c[-8:] = run
    jg, pg = _grids(c, valid, 256, bsz=2)
    q = np.concatenate([c, c + 1, run])
    qv = np.ones(len(q), bool)
    qv[::7] = False
    ref = jax.jit(lambda g, q, v: mt.ops.lookup_sorted(
        g.coords, g.valid, g.stride, q, v))(jg, jnp.asarray(q),
                                            jnp.asarray(qv))
    got = mp.ops.lookup_sorted(pg.coords, pg.valid, pg.stride, _t(q), _t(qv))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    tail = _np(got)[-8:]
    assert (tail[:4] >= 0).all() and (tail[4:] == -1).all()
    # the hash table finds them all
    assert (_np(phash.lookup(pg.hash_table(), _t(run))) >= 0).all()


def _hash_route(monkeypatch):
    """Send ``grid_lookup`` down the hash route, as on CUDA tensors."""
    monkeypatch.setattr(mp.ops.neighbors, "lookup_route",
                        lambda grid, device: "hash")


def test_grid_lookup_routes_match_jax(rng, monkeypatch):
    """The route by grid and device, and each route's rows: JAX's own
    routes on the CPU (sorted; the hash table called directly)."""
    c, valid = _padded(rng, _coords(rng, 300))
    jg, pg = _grids(c, valid, 320)
    q = np.concatenate([c, c - 1])
    qv = rng.rand(len(q)) > 0.1
    ref_sorted = jax.jit(lambda g, q, v: mt.ops.grid_lookup(g, q, v))(
        jg, jnp.asarray(q), jnp.asarray(qv))
    ref_hash = jax.jit(lambda g, q, v: jhash.lookup(
        g.hash_table(), q, v))(jg, jnp.asarray(q), jnp.asarray(qv))
    np.testing.assert_array_equal(np.asarray(ref_hash),
                                  np.asarray(ref_sorted))
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert mp.ops.lookup_route(pg, cpu) == "sorted"
    assert mp.ops.lookup_route(pg, cuda) == "hash"
    bounded = mp.SparseGrid(coords=pg.coords, valid=pg.valid, batch_size=3,
                            extent=(64,) * 3)
    assert mp.ops.lookup_route(bounded, cuda) == "lut"
    got = mp.ops.grid_lookup(pg, _t(q), _t(qv))
    np.testing.assert_array_equal(_np(got), np.asarray(ref_sorted))
    _hash_route(monkeypatch)
    got = mp.ops.grid_lookup(pg, _t(q), _t(qv))
    np.testing.assert_array_equal(_np(got), np.asarray(ref_hash))
    np.testing.assert_array_equal(_np(pg.hash_table().slots),
                                  np.asarray(jg.hash_table().slots))
    assert pg.hash_table() is pg.hash_table()


def test_kernel_maps_and_grid_maps_unbounded_match_jax(rng, monkeypatch):
    """``kernel_map`` (k3s1, k3s2, k2s2 transpose) by both routes,
    ``membership``, ``identity_map`` and ``get_coords_map``."""
    c, valid = _padded(rng, _coords(rng, 300, lo=-20, hi=20))
    jg, pg = _grids(c, valid, 320)
    js = jax.jit(lambda g: mt.ops.stride_grid(g, 2, 320))(jg)
    ps = mp.ops.stride_grid(pg, 2, 320)
    for pair, spec in (((0, 0), dict(kernel_size=3)),
                       ((0, 1), dict(kernel_size=3, stride=2)),
                       ((1, 0), dict(kernel_size=2, stride=2,
                                     transpose=True))):
        jspec = mt.ops.KernelSpec(ndim=3, **spec)
        pspec = mp.ops.KernelSpec(ndim=3, **spec)
        ja, jb = ((jg, js)[i] for i in pair)
        pa, pb = ((pg, ps)[i] for i in pair)
        ref = jax.jit(lambda a, b: mt.ops.kernel_map(a, b, jspec))(ja, jb)
        with monkeypatch.context() as m:
            for hashed in (False, True):
                if hashed:
                    _hash_route(m)
                got = mp.ops.kernel_map(pa, pb, pspec)
                np.testing.assert_array_equal(_np(got), np.asarray(ref))
    ref = jax.jit(mt.ops.membership)(jg, jg)
    np.testing.assert_array_equal(_np(mp.ops.membership(pg, pg)),
                                  np.asarray(ref))
    jm, pm = _grids(c[::2], valid[::2], 200)
    for fn in ("membership", "identity_map"):
        ref = jax.jit(getattr(mt.ops.neighbors, fn))(jg, jm)
        got = getattr(mp.ops, fn)(pg, pm)
        np.testing.assert_array_equal(_np(got), np.asarray(ref))
    ref = jax.jit(mt.ops.neighbors.get_coords_map)(jg, js)
    got = mp.ops.get_coords_map(pg, ps)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    assert (_np(got)[_np(pg.valid)] >= 0).all()
    with pytest.raises(ValueError):
        mp.ops.get_coords_map(ps, pg)


def test_huge_bounded_grid_takes_the_morton_path(rng):
    """An extent of 2³⁰ cells or more has no int32 flat key: JAX sorts it
    by (batch, Morton) and searches it so, extent kept."""
    ext = (1024, 1024, 1024)
    c, valid = _padded(rng, _coords(rng, 300, lo=0, hi=1024))
    assert mp.ops.coords._flat_bound(ext, (1, 1, 1), 3) is None
    jg, pg = _grids(c, valid, 320, extent=ext)
    _same_grid(jg, pg)
    assert mp.ops.lookup_route(pg, torch.device("cuda")) == "sorted"
    q = np.concatenate([c, c + 1])
    ref = jax.jit(lambda g, q: mt.ops.grid_lookup(g, q))(jg, jnp.asarray(q))
    got = mp.ops.grid_lookup(pg, _t(q))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    with pytest.raises(ValueError):
        pg.flat_keys()


def _tensor_pair(rng, n, cap, extent=None, batch=2, cin=4, lo=0, hi=16):
    c = _coords(rng, n, batch=batch, lo=lo, hi=hi)
    f = rng.randn(n, cin).astype(np.float32)
    jst = jax.jit(lambda c, f: mt.sparse_tensor(
        c, f, cap, 1, batch, extent=extent))(jnp.asarray(c), jnp.asarray(f))
    pst = mp.sparse_tensor(_t(c), _t(f), cap, 1, batch, extent=extent)
    _same_grid(jst.grid, pst.grid)
    return jst, pst


def test_union_unbounded_and_mixed_match_jax(rng):
    """With an unbounded input the union is unbounded and in Morton
    order: row for row JAX's, features at 1e-6."""
    ja, pa = _tensor_pair(rng, 80, 96, lo=-8)
    jb, pb = _tensor_pair(rng, 60, 64, extent=(16,) * 3)
    jc, pc = _tensor_pair(rng, 50, 64, lo=-8)
    for js, ps in (([ja, jc], [pa, pc]), ([ja, jb], [pa, pb]),
                   ([jb, ja, jc], [pb, pa, pc])):
        jg, jf = jax.jit(lambda ts: mt.ops.union(
            [t.grid for t in ts], [t.features for t in ts], 200))(js)
        pg, pf = mp.ops.union([t.grid for t in ps], [t.features for t in ps],
                              200)
        _same_grid(jg, pg)
        assert pg.extent is None
        np.testing.assert_allclose(_np(pf), np.asarray(jf), rtol=0,
                                   atol=1e-6)


def test_bounded_union_keeps_the_flat_key_order(rng):
    """Departure (3), ROADMAP.md §C: JAX's union of bounded inputs comes
    in Morton order but carries an extent, so its rows are not sorted by
    the flat cell key that bounded grids promise and the sorted search
    relies on; the port's are, and hold the same rows and sums."""
    ext = (16,) * 3
    ja, pa = _tensor_pair(rng, 80, 96, extent=ext)
    jb, pb = _tensor_pair(rng, 60, 64, extent=ext)
    jg, jf = jax.jit(lambda a, b: mt.ops.union(
        [a.grid, b.grid], [a.features, b.features], 200))(ja, jb)
    pg, pf = mp.ops.union([pa.grid, pb.grid], [pa.features, pb.features],
                          200)
    assert jg.extent == pg.extent == ext
    jkey = np.asarray(mt.ops.coords.flat_cell_key(
        jg.coords, jg.valid, (1,) * 3, ext))[np.asarray(jg.valid)]
    pkey = _np(pg.flat_keys())[_np(pg.valid)]
    assert (np.diff(jkey) < 0).any() and (np.diff(pkey) > 0).all()
    jrows = {tuple(r): f for r, f, v in zip(np.asarray(jg.coords).tolist(),
                                            np.asarray(jf),
                                            np.asarray(jg.valid)) if v}
    prows = {tuple(r): f for r, f, v in zip(_np(pg.coords).tolist(),
                                            _np(pf), _np(pg.valid)) if v}
    assert set(jrows) == set(prows)
    np.testing.assert_allclose(np.stack([prows[k] for k in jrows]),
                               np.stack(list(jrows.values())), atol=1e-6)


@pytest.mark.parametrize("mode,sigma", [("none", None), ("uniform", 0.7)])
def test_noise_near_on_unbounded_latent_matches_jax(rng, mode, sigma):
    """On an unbounded latent the port keeps the neighbours outside any
    extent, as JAX: the near grid and the union row for row JAX's (JAX's
    draws handed over)."""
    c = _coords(rng, 120, batch=2, lo=0, hi=8) * 8
    f = rng.randn(120, 4).astype(np.float32)
    jl = jax.jit(lambda c, f: mt.sparse_tensor(c, f, 160, 8, 2))(
        jnp.asarray(c), jnp.asarray(f))
    pl = mp.sparse_tensor(_t(c), _t(f), 160, 8, 2)
    cap, key = 2048, jax.random.PRNGKey(4)
    jout = jax.jit(lambda lat, key: md.inject_noise_points(
        lat, key, mode, latent_resolution=8, noise_point_max=16,
        capacity=cap, noise_near=True,
        near_sigma=None if sigma is None else jnp.float32(sigma)))(jl, key)
    r_pts, r_feat = jax.random.split(key)
    extra = {}
    if mode == "uniform":
        extra["points"] = _t(jax.random.randint(r_pts, (2 * 16, 3), 0, 8))
    if sigma is not None:
        extra["near_noise"] = _t(jax.random.normal(r_feat, (cap, 4)))
    got = mp.diffusion.inject_noise_points(
        pl, mode, latent_resolution=8, noise_point_max=16, capacity=cap,
        noise_near=True, near_sigma=sigma, **extra)
    _same_grid(jout.grid, got.grid)
    assert (_np(got.grid.coords)[_np(got.grid.valid)][:, 1:] < 0).any()
    np.testing.assert_allclose(_np(got.features), np.asarray(jout.features),
                               rtol=0, atol=1e-6)


def _carry(jm, args, module, rng):
    """Random flax variables of ``jm``'s shapes (``eval_shape``: no JAX
    ``init`` compile), loaded into the port's ``module``."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    variables = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.3),
        shapes)
    load_flax(module, variables)
    return variables


def test_convs_on_unbounded_grid_match_flax(rng):
    """SparseConv k3, the strided k2-s2 and k3-s2 convs,
    SparseConvTranspose pinned to the fine grid and
    GenerativeConvTranspose on unbounded grids: the plain route (a kernel
    map and a GEMM), against flax ``apply`` with converted parameters."""
    jst, pst = _tensor_pair(rng, 200, 256, lo=-10, hi=10, cin=5)
    cases = [
        ("k3", mt.nn.SparseConv(6, 3, use_bias=True),
         mp.nn.SparseConv(5, 6, 3, use_bias=True, device="cpu"), (), ()),
        ("k2s2", mt.nn.SparseConv(6, 2, 2, out_capacity=160),
         mp.nn.SparseConv(5, 6, 2, 2, out_capacity=160, device="cpu"), (),
         ()),
        ("k3s2", mt.nn.SparseConv(6, 3, 2, out_capacity=160),
         mp.nn.SparseConv(5, 6, 3, 2, out_capacity=160, device="cpu"), (),
         ())]
    outs = {}
    with mp.nn.record_routes() as routes:
        for name, jm, pm, jargs, pargs in cases:
            v = _carry(jm, (jst, *jargs), pm, rng)
            ref = jax.jit(lambda v, x: jm.apply(v, x))(v, jst)
            got = pm(pst, *pargs)
            _same_grid(ref.grid, got.grid)
            np.testing.assert_allclose(_np(got.features),
                                       np.asarray(ref.features), **CONV_TOL)
            outs[name] = (ref, got)
        jc, pc = outs["k2s2"]
        for name, jm, pm, jargs, pargs in (
                ("T", mt.nn.SparseConvTranspose(3),
                 mp.nn.SparseConvTranspose(6, 3, device="cpu"),
                 (jst.grid,), (pst.grid,)),
                ("G", mt.nn.GenerativeConvTranspose(3, out_capacity=1024),
                 mp.nn.GenerativeConvTranspose(6, 3, out_capacity=1024,
                                               device="cpu"), (), ())):
            v = _carry(jm, (jc, *jargs), pm, rng)
            ref = jax.jit(lambda v, x, *a: jm.apply(v, x, *a))(v, jc, *jargs)
            got = pm(pc, *pargs)
            _same_grid(ref.grid, got.grid)
            np.testing.assert_allclose(_np(got.features),
                                       np.asarray(ref.features), **CONV_TOL)
    assert {r.branch for r in routes} == {"plain"} and len(routes) == 5
