"""The fused conv's kernel domain, and its float32 compute on the CPU.

- ``kernel_domain`` over compute dtype x D, ``offset_bands`` over K, and
  the operators' CUDA implementations (driven here on CPU tensors with the
  launchers stood in by their checks and plain versions): one launch per
  band of at most 125 offsets, counted in ``.launches``, B1/B2's bands
  summed and B3's concatenated to the plain versions' result; a compute
  dtype outside the domain raises before any launch.
- The float32 cast pass's plain version: three bf16 terms (``split_terms``)
  rebuild a float32 value within 2^-24·|x|, as ``pad_features``,
  ``pack_weight`` and ``dw_operands`` lay them out; the kernels' split-term
  product (``split_mm`` here, the sum of the term products with
  i + j <= 2) against a float64 product, and the tile rules of the
  split-term instantiations.
- B1 at float32 compute on the CPU (its plain version, and the split-term
  product on the same gathered rows) against JAX's ``_fused_impl`` in
  interpret mode (``compute_dtype=float32, interpret=True``) on a 2-D conv,
  at 2e-5 (float32, summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.ops import fused_conv as fc
from mink_octtree_stablediffusion_tpu_torch.ops import library

torch.set_num_threads(1)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("ndim", [1, 2, 3, 4])
def test_kernel_domain(dtype, ndim):
    want = dtype in (torch.bfloat16, torch.float32) and ndim in (2, 3)
    assert fc.kernel_domain(dtype, ndim) == want
    for k in (1, 8, 27, 125, 126, 250, 343):
        bands = fc.offset_bands(k)
        assert len(bands) == -(-k // 125), k
        assert [b[0] for b in bands] == [0] + [b[1] for b in bands[:-1]]
        assert bands[-1][1] == k and all(
            1 <= b1 - b0 <= 125 for b0, b1 in bands)


def _grid(rng, ext=8, cap=256, ndim=3):
    c = np.unique(rng.randint(0, ext, (150, ndim)), axis=0)
    coords = np.concatenate([np.zeros((len(c), 1), np.int32), c], 1)
    cpad, valid = mp.ops.pad_to_capacity(coords.astype(np.int32), cap)
    return mp.sparse_tensor(_t(cpad), torch.ones(cap, 1), capacity=cap,
                            valid=_t(valid), extent=(ext,) * ndim).grid


@pytest.mark.parametrize("case", ["k7_cube", "float64_compute", "k3_f32",
                                  "k3_2d_bf16"])
def test_operators_launch_in_offset_bands(rng, monkeypatch, case):
    """The fused conv's three CUDA implementations, called on CPU tensors
    with the launchers stood in by the launchers' checks and the plain
    versions: one launch per band of offsets (K = 343: 125, 125, 93), each
    counted, whose sum (B1, B2) or concatenation (B3) is the plain version
    over all offsets; float64 compute raises before any launch."""
    ndim = 2 if case == "k3_2d_bf16" else 3
    ks = 7 if case == "k7_cube" else 3
    cd = {"float64_compute": torch.float64,
          "k3_2d_bf16": torch.bfloat16}.get(case, torch.float32)
    grid = _grid(rng, ndim=ndim)
    spec = mp.ops.KernelSpec(ks, 1, ndim=ndim)
    offs, s_in, cells = fc.conv_geometry(grid, spec)
    f = torch.randn(grid.capacity, 4) * grid.valid[:, None]
    g = torch.randn(grid.capacity, 5) * grid.valid[:, None]
    w = torch.randn(spec.volume, 4, 5) * 0.1
    launched = []

    def launch(features, kernel, keys, coords, valid, offs_, s, c, cd_,
               transpose_weight=False):
        fc._check_operands(features.device, cd_, offs_, kernel.shape[0])
        launched.append(("B2" if transpose_weight else "B1", len(offs_)))
        k_ = kernel.transpose(1, 2) if transpose_weight else kernel
        return fc._fused_sparse_conv_plain(features, k_, keys, coords, valid,
                                           offs_, s, c, cd_)

    def launch_dkernel(features, g_, keys, coords, valid, offs_, s, c, cd_):
        fc._check_operands(features.device, cd_, offs_, len(offs_))
        launched.append(("B3", len(offs_)))
        return fc._dkernel_plain(features, g_, keys, coords, valid, offs_, s,
                                 c, cd_)
    monkeypatch.setattr(fc, "_launch", launch)
    monkeypatch.setattr(fc, "_launch_dkernel", launch_dkernel)
    wrappers = (fc.fused_sparse_conv, fc.fused_conv_dfeatures,
                fc.fused_conv_dkernel)
    before = [w_.launches for w_ in wrappers]
    flat, ext = [int(v) for v in offs.reshape(-1)], list(grid.extent)
    keys = grid.flat_keys()
    calls = (
        lambda: library._fused_cuda(f, w, keys, grid.coords, grid.valid, keys,
                                    grid.coords, grid.valid, flat,
                                    list(s_in), ext, list(s_in), ext, cd),
        lambda: library._dfeatures_cuda(g, w, keys, grid.coords, grid.valid,
                                        [-v for v in flat], list(s_in),
                                        cells, cd),
        lambda: library._dkernel_cuda(f, g, keys, grid.coords, grid.valid,
                                      flat, list(s_in), cells, cd))
    if case == "float64_compute":
        assert not fc.kernel_domain(cd, ndim)
        for call in calls:
            with pytest.raises(NotImplementedError):
                call()
        assert launched == []
        assert [w_.launches for w_ in wrappers] == before
        return
    outs = [call() for call in calls]
    bands = [k1 - k0 for k0, k1 in fc.offset_bands(spec.volume)]
    assert bands == ([125, 125, 93] if case == "k7_cube" else [spec.volume])
    assert launched == [(n, b) for n in ("B1", "B2", "B3") for b in bands]
    assert [a - b for a, b in zip([w_.launches for w_ in wrappers],
                                  before)] == [len(bands)] * 3
    refs = (fc._fused_sparse_conv_plain(f, w, keys, grid.coords, grid.valid,
                                        offs, s_in, cells, cd),
            fc._fused_sparse_conv_plain(g, w.transpose(1, 2), keys,
                                        grid.coords, grid.valid, -offs,
                                        s_in, cells, cd),
            fc._dkernel_plain(f, g, keys, grid.coords, grid.valid, offs,
                              s_in, cells, cd))
    for got, ref in zip(outs, refs):
        assert got.shape == ref.shape
        if len(bands) == 1:
            assert torch.equal(got, ref)
        else:  # the bands' float32 sums in another order
            assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_split_terms_rebuild_float32():
    rng = np.random.RandomState(1)
    x = _t((rng.randn(4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(
        np.float32))
    t = fc.split_terms(x, 3)
    assert t.dtype == torch.bfloat16 and t.shape == (3, 4096)
    back = t.double().sum(0)
    assert torch.all((back - x.double()).abs() <= 2.0 ** -24 * x.double().abs())
    # the layouts of the cast passes (B1's features and weight, B3's f, g)
    f = x[:300].reshape(60, 5)
    pf = fc.pad_features(f, 3)
    assert pf.shape == (3, 60, 8) and torch.all(pf[:, :, 5:] == 0)
    assert torch.equal(pf[:, :, :5], fc.split_terms(f, 3))
    assert torch.equal(fc.pad_features(f, 1), fc.pad_features(f))
    w = x[:27 * 5 * 7].reshape(27, 5, 7)
    for transpose in (False, True):
        wp = fc.pack_weight(w, transpose, 32, 16, 3)
        wt = w.transpose(1, 2) if transpose else w
        cin, cout = wt.shape[1:]
        assert wp.shape == (3, 27, 16, 32)
        assert torch.equal(wp[:, :, :cin, :cout], fc.split_terms(wt, 3))
        assert torch.all(wp[:, :, cin:] == 0) and torch.all(
            wp[:, :, :, cout:] == 0)
    fb, gb = fc.dw_operands(f, f[:, :3], 3)
    assert fb.shape == (3, 60, 8) and gb.shape == (3, 60, 8)
    assert torch.equal(gb[:, :, :3], fc.split_terms(f[:, :3], 3))


def split_mm(a: torch.Tensor, b: torch.Tensor, terms: tuple) -> torch.Tensor:
    """The kernels' split-term product in plain PyTorch: ``a @ b`` as the
    sum of ``split_terms(a)_i @ split_terms(b)_j`` over ``i + j ≤ 2``, each
    product of bf16 values exact in float32, summed in float32, the
    smallest first."""
    ta, tb = fc.split_terms(a, terms[0]).float(), fc.split_terms(
        b, terms[1]).float()
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for i in reversed(range(terms[0])):
        for j in reversed(range(terms[1])):
            if i + j <= 2:
                out += ta[i] @ tb[j]
    return out


@pytest.mark.parametrize("terms", [(3, 3), (3, 1), (1, 1)])
def test_split_mm_against_float64(terms):
    """The split-term product: (3, 3) within float32 summation error of a
    float64 product; (3, 1) the same on a bf16-exact weight; (1, 1) the
    bf16 product."""
    rng = np.random.RandomState(2)
    a = _t(rng.randn(64, 96).astype(np.float32))
    b = _t(rng.randn(96, 40).astype(np.float32))
    if terms[1] == 1:
        b = b.bfloat16().float()
    if terms == (1, 1):
        a16 = a.bfloat16().double()
        ref = a16 @ b.double()
    else:
        ref = a.double() @ b.double()
    got = split_mm(a, b, terms).double()
    scale = (a.double().abs() @ b.double().abs())
    assert torch.all((got - ref).abs() <= 96 * 2.0 ** -24 * scale + 1e-30)


def test_split_term_tiles():
    """B1's split-term tile: BK 16 (``tile_shape``); B3's pairs a stage
    with three terms (``dw_tile_shape``): within 24 KB, at least one k16
    step a group of warps splitting the depth."""
    assert fc.tile_shape(512, 512, (3, 3)) == (128, 16)
    assert fc.tile_shape(3, 32, (3, 1)) == (32, 16)
    assert fc.operand_terms(torch.bfloat16) == (1, 1)
    assert fc.operand_terms(torch.float32) == (3, 3)
    assert fc.operand_terms(torch.float32, w_bf16=True) == (3, 1)
    want = {(32, 32): 128, (32, 64): 64, (32, 128): 32, (64, 32): 64,
            (64, 64): 32, (64, 128): 16, (128, 32): 32, (128, 64): 16,
            (128, 128): 16}
    for (ci, co), bd in want.items():
        bi, bo, got = fc.dw_tile_shape(ci, co, 3)
        assert (bi, bo, got) == (ci, co, bd)
    assert fc.dw_tile_shape(32, 32) == (32, 32, 128)
    assert fc.dw_splits(16384, 512, 512, 27, 3) == 1


def test_b1_float32_2d_matches_jax_interpret(rng):
    res, cin, cout, cap = 12, 5, 6, 128
    c = np.unique(rng.randint(0, res, (100, 2)), axis=0)
    coords = np.concatenate([np.zeros((len(c), 1), np.int32), c],
                            1).astype(np.int32)
    cpad, valid = mt.ops.pad_to_capacity(coords, cap)
    feats = (rng.randn(cap, cin) * valid[:, None]).astype(np.float32)
    kern = (rng.randn(9, cin, cout) * 0.1).astype(np.float32)
    jst = jax.jit(lambda c, f, v: mt.sparse_tensor(
        c, f, capacity=cap, valid=v, extent=(res, res)))(
        jnp.asarray(cpad), jnp.asarray(feats), jnp.asarray(valid))
    spec = mt.ops.KernelSpec(3, 1, ndim=2)
    ref = np.asarray(mt.ops.fused_sparse_conv(
        jst.features, jnp.asarray(kern), jst.grid, jst.grid, spec, None,
        tile=128, tw=128, compute_dtype=jnp.float32, interpret=True))

    pst = mp.sparse_tensor(_t(cpad), _t(feats), capacity=cap, valid=_t(valid),
                           extent=(res, res))
    pspec = mp.ops.KernelSpec(3, 1, ndim=2)
    got = mp.ops.fused_sparse_conv(pst.features, _t(kern), pst.grid,
                                   pst.grid, pspec,
                                   compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), ref, rtol=2e-5, atol=2e-5)
    # the kernel's split-term arithmetic on the same gathered rows
    offs, s_in, cells = fc.conv_geometry(pst.grid, pspec)
    rows = fc._gathered(pst.features, pst.grid.flat_keys(), pst.grid.coords,
                        pst.grid.valid, offs, s_in, cells, torch.float32)
    split = split_mm(rows.reshape(cap, 9 * cin), _t(kern).reshape(
        9 * cin, cout), fc.operand_terms(torch.float32))
    np.testing.assert_allclose(_np(split), ref, rtol=2e-5, atol=2e-5)


def test_brick_gate_takes_float32(monkeypatch):
    """With the brick gate on, ``brick_preferred`` is JAX's rule: it has
    no compute-dtype clause (JAX's has none; the brick kernels compute
    float32 through their split-term instantiations), so a float32 conv
    takes the route as a bf16 one does, and it equals JAX's
    ``brick_preferred`` over `test_torch_brick.py`'s routing table at the
    widths the float32 paths give it, never taking a CPU conv."""
    import inspect
    import test_torch_brick as tb
    from mink_octtree_stablediffusion_tpu.ops import vol_conv as jvc
    from mink_octtree_stablediffusion_tpu_torch.ops import vol_conv as pvc
    assert list(inspect.signature(pvc.brick_preferred).parameters) == [
        "spec", "grid", "cin", "cout", "device"]
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    rows, taken = 4, set()
    for kw, (extent, stride, bsz) in tb._routing_table():
        jg = mt.ops.SparseGrid(coords=jnp.zeros((rows, 4), jnp.int32),
                               valid=jnp.ones(rows, bool),
                               stride=(stride,) * 3, batch_size=bsz,
                               extent=extent)
        pg = mp.ops.SparseGrid(coords=torch.zeros(rows, 4, dtype=torch.int32),
                               valid=torch.ones(rows, dtype=torch.bool),
                               stride=(stride,) * 3, batch_size=bsz,
                               extent=extent)
        js, ps = tb._spec(mt, kw), tb._spec(mp, kw)
        for cin, cout in ((4, 4), (32, 32), (128, 128), (129, 4)):
            jvc.enable_brick_conv(True)
            pvc.enable_brick_conv(True)
            try:
                want = jvc.brick_preferred(js, jg, cin, cout)
                got = pvc.brick_preferred(ps, pg, cin, cout, "cuda")
                on_cpu = pvc.brick_preferred(ps, pg, cin, cout, "cpu")
            finally:
                jvc.enable_brick_conv(False)
                pvc.enable_brick_conv(False)
            assert got == want, (kw, extent, cin, cout)
            assert not on_cpu
            taken.add(want)
    assert taken == {True, False}


def test_brick_f32_terms_rebuild_float32(rng):
    """The float32 brick instantiations' operands: the three-term weight
    pack (``vol_conv.pack_weight(..., terms=3)``, forward and mirrored)
    and the volume's terms (``split_terms`` of a float32 padded volume,
    the cast pass's plain version) sum back to the float32 values within
    2⁻²⁴ of each; term 0 of the pack is the bf16 pack; the Cout tile is at
    most 64; and the six products of terms, each a float32 sum of exact
    bf16 products as on the tensor cores, give B5's float32 function and
    B6's within 2e-5·max|ref|."""
    from mink_octtree_stablediffusion_tpu_torch.ops import vol_conv as pvc
    cin, cout = 20, 90
    k = _t((rng.randn(27, cin, cout) * 10.0 ** rng.uniform(
        -3, 1, (27, cin, cout))).astype(np.float32))
    assert pvc.tile_cout(cout, 3) == 64 and pvc.tile_cout(cout) == 128
    kt = fc.split_terms(k, 3)
    assert torch.all((kt.double().sum(0) - k.double()).abs() <=
                     2.0 ** -24 * k.double().abs())
    for mirror in (False, True):
        w3 = pvc.pack_weight(k, mirror, terms=3)
        assert w3.dtype == torch.bfloat16 and w3.shape[0] == 3
        # term u of the pack is the pack of term u (exact in bf16), laid
        # out in the 64-wide Cout tiles of the float32 instantiation
        for u in range(3):
            wu = kt[u].float()
            assert torch.equal(w3[u], pvc.pack_weight(wu, mirror, terms=3)[0])
            ref = pvc._mirror_transpose(wu) if mirror else wu
            got = w3[u].float().permute(2, 1, 4, 6, 0, 3, 5).reshape(
                27, w3.shape[2] * 16, -1)
            assert torch.equal(got[:, :ref.shape[1], :ref.shape[2]], ref)
            assert torch.all(got[:, ref.shape[1]:] == 0)
            assert torch.all(got[:, :, ref.shape[2]:] == 0)
    vol = _t(rng.randn(2, 8, 8, 16, cin).astype(np.float32))
    volp = pvc.pad_volume(vol, torch.float32)
    assert volp.dtype == torch.float32
    vt = fc.split_terms(volp, 3)
    assert torch.all((vt.double().sum(0) - volp.double()).abs() <=
                     2.0 ** -24 * volp.double().abs())
    got = sum(pvc._vol_conv_plain(vt[i].float(), kt[j].float())
              for i in range(3) for j in range(3) if i + j <= 2)
    ref = pvc._vol_conv_plain(volp.double(), k.double())
    assert (got.double() - ref).abs().max() <= 2e-5 * ref.abs().max()
    gvolp = pvc.pad_volume(_t(rng.randn(2, 8, 8, 16, cout).astype(
        np.float32)), torch.float32)
    gt = fc.split_terms(gvolp, 3)
    got = sum(pvc._vol_conv_dw_plain(vt[i].float(), gt[j].float(), cin,
                                     cout)
              for i in range(3) for j in range(3) if i + j <= 2)
    ref = pvc._vol_conv_dw_plain(volp.double(), gvolp.double(), cin, cout)
    assert (got.double() - ref).abs().max() <= 2e-5 * ref.abs().max()
