"""The passes of B3, the fused conv's dW kernel (``csrc/
fused_sparse_conv_dw.cu``), in plain PyTorch, against loop definitions and
against the JAX package, on the CPU.

- The cast (``dw_operands``): the features and the cotangent as bf16 [N,
  C rounded up to 8], zero past C, exactly.
- The compacted pair list (``pair_list``): per offset, the matched (input
  row, output row) pairs in ascending output row, exactly as a loop over
  ``query_keys`` / ``neighbor_index`` gives them, on the four conv kinds,
  on a grid where some offsets have no pair, and on a grid whose rows are
  all invalid.
- The GEMM over the pairs with its split-and-reduce order
  (``_dkernel_pairs_plain``): on bf16-rounded operands it equals
  ``_dkernel_plain`` up to float32 summation order (1e-5·max|ref|), for
  every split count; in float32 it matches JAX's ``_dkernel_fused`` (the
  Pallas dW kernel in interpret mode, reached through ``jax.grad`` of
  ``fused_sparse_conv``) at rtol = atol = 2e-5, as
  `tests/test_torch_fused_conv.py` holds the forward.
- The tile and split rules (``dw_tile_shape``, ``dw_splits``).

``tests/test_torch_cuda.py`` holds the kernel's passes equal to these on
the card.  No kernel is launched here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu.ops import onehot_conv as jax_onehot
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.ops import fused_conv

torch.set_num_threads(1)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _coords(rng, n, ext, bsz, even_x=False):
    rows = []
    for b in range(bsz):
        c = np.unique(rng.randint(0, ext, (n, 3)), axis=0)
        if even_x:
            c = np.unique(c * [2, 1, 1] % ext, axis=0)
        rows.append(np.concatenate([np.full((len(c), 1), b, np.int32), c], 1))
    return np.concatenate(rows).astype(np.int32)


KINDS = {
    # name: (kernel spec kwargs, geometry)
    "k3s1": (dict(kernel_size=3), "same"),
    "k3s2": (dict(kernel_size=3, stride=2), "down"),
    "k2s2T": (dict(kernel_size=2, stride=2, transpose=True), "up"),
    "k2s2G": (dict(kernel_size=2, stride=2, transpose=True), "grow"),
}


def _torch_grids(name, seed=0, even_x=False, invalid=False):
    """(in_grid, out_grid, spec) of one conv kind on a random 2-instance
    grid (12³ extent, 512 rows)."""
    kw, geom = KINDS[name]
    cpad, valid = mp.ops.pad_to_capacity(
        _coords(np.random.RandomState(seed), 300, 12, 2, even_x), 512)
    if invalid:
        valid[:] = False
    g, _, _ = mp.ops.make_grid(_t(cpad), _t(valid), 512, 1, 2,
                               extent=(12,) * 3)
    spec = mp.ops.KernelSpec(ndim=3, **kw)
    if geom == "same":
        return g, g, spec
    g2 = mp.ops.stride_grid(g, 2, 256)
    if geom == "down":
        return g, g2, spec
    if geom == "up":
        return g2, g, spec
    return g2, mp.ops.expand_grid(g2, spec.absolute_offsets(g2.stride),
                                  (1, 1, 1), 2048), spec


def _loop_pairs(in_grid, out_grid, spec):
    """Per offset, the (input row, output row) pairs of a loop over the
    output rows of the forward's match table."""
    offs, s_in, cells = fused_conv.conv_geometry(in_grid, spec)
    match = _np(fused_conv.neighbor_index(
        in_grid.flat_keys(), fused_conv.query_keys(
            out_grid.coords, out_grid.valid, offs, s_in, cells)))
    return [[(int(match[j, k]), j) for j in range(match.shape[0])
             if match[j, k] >= 0] for k in range(match.shape[1])]


def _pairs(in_grid, out_grid, spec):
    offs, s_in, cells = fused_conv.conv_geometry(in_grid, spec)
    return fused_conv.pair_list(in_grid.flat_keys(), out_grid.coords,
                                out_grid.valid, offs, s_in, cells)


@pytest.mark.parametrize("cin,cout", [(1, 4), (3, 32), (8, 8), (33, 129),
                                      (512, 512)])
def test_dw_operands_match_definition(cin, cout):
    """``fb[r, c] = bf16(f[r, c])`` and ``gb[r, c] = bf16(g[r, c])`` below
    the width, 0 up to the width rounded up to 8."""
    rng = np.random.RandomState(cin * 1000 + cout)
    f = _t(rng.randn(37, cin).astype(np.float32))
    g = _t(rng.randn(29, cout).astype(np.float32))
    fb, gb = fused_conv.dw_operands(f, g)
    for got, x in ((fb, f), (gb, g)):
        n, c = x.shape
        want = torch.zeros(n, -(-c // 8) * 8, dtype=torch.bfloat16)
        for r in range(n):
            for i in range(c):
                want[r, i] = x[r, i].to(torch.bfloat16)
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(KINDS))
def test_pair_list_matches_loop(name):
    """Offset k's pairs at ``starts[k]:starts[k + 1]``, as the loop gives
    them (so in ascending output row), on each conv kind."""
    gi, go, spec = _torch_grids(name)
    starts, pin, pout = _pairs(gi, go, spec)
    want = _loop_pairs(gi, go, spec)
    assert starts.dtype == pin.dtype == pout.dtype == torch.int32
    assert starts.tolist() == list(np.cumsum([0] + [len(w) for w in want]))
    assert sum(map(len, want)) > 0
    for k, w in enumerate(want):
        a, b = int(starts[k]), int(starts[k + 1])
        assert list(zip(pin[a:b].tolist(), pout[a:b].tolist())) == w, k


def test_pair_list_offsets_without_pairs_and_invalid_rows():
    """On a k3s1 grid of even x only, every offset with an odd x shift has
    no pair (and the others have); on a grid whose rows are all invalid
    the list is empty."""
    gi, go, spec = _torch_grids("k3s1", even_x=True)
    starts, pin, pout = _pairs(gi, go, spec)
    counts = (starts[1:] - starts[:-1]).tolist()
    want = _loop_pairs(gi, go, spec)
    offs = spec.absolute_offsets(gi.stride)
    for k, w in enumerate(want):
        assert counts[k] == len(w) and (counts[k] == 0) == (offs[k, 0] != 0)
        a = int(starts[k])
        assert list(zip(pin[a:a + len(w)].tolist(),
                        pout[a:a + len(w)].tolist())) == w
    gi, go, spec = _torch_grids("k3s1", invalid=True)
    starts, pin, pout = _pairs(gi, go, spec)
    assert starts.tolist() == [0] * 28 and pin.numel() == pout.numel() == 0


@pytest.mark.parametrize("splits", [1, 3, 7, 64])
def test_pairs_split_reduce_equals_dkernel_plain(splits):
    """dW assembled from the pairs in chunks of 16, split in ``splits``
    runs and summed in order, on bf16 operands, against ``_dkernel_plain``
    on the same operands: float32 summation order only (1e-5·max|ref| +
    1e-6), on each conv kind; a split with no pair adds zeros."""
    for name in KINDS:
        gi, go, spec = _torch_grids(name, seed=1)
        rng = np.random.RandomState(splits)
        f = _t(rng.randn(gi.capacity, 5).astype(np.float32)) * gi.valid[:,
                                                                        None]
        g = _t(rng.randn(go.capacity, 6).astype(np.float32)) * go.valid[:,
                                                                        None]
        offs, s_in, cells = fused_conv.conv_geometry(gi, spec)
        ref = fused_conv._dkernel_plain(f, g, gi.flat_keys(), go.coords,
                                        go.valid, offs, s_in, cells,
                                        torch.bfloat16)
        got = fused_conv._dkernel_pairs_plain(
            f, g, *_pairs(gi, go, spec), splits, 16, torch.bfloat16)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item() + 1e-6, (name, err)


def _jax_case(name, cin, cout, seed, monkeypatch):
    """The same conv in both packages: (JAX's dW of ``fused_sparse_conv``
    in interpret mode, float32, which must reach ``_dkernel_fused``; the
    port's features, cotangent, grids and spec)."""
    kw, geom = KINDS[name]
    rng = np.random.RandomState(seed)
    cpad, valid = mp.ops.pad_to_capacity(_coords(rng, 300, 12, 2), 512)
    jg = jax.jit(lambda c, v: mt.ops.make_grid(
        c, v, 512, 1, 2, extent=(12,) * 3)[0])(jnp.asarray(cpad),
                                               jnp.asarray(valid))
    pg, _, _ = mp.ops.make_grid(_t(cpad), _t(valid), 512, 1, 2,
                                extent=(12,) * 3)
    jspec, spec = (mt.ops.KernelSpec(ndim=3, **kw),
                   mp.ops.KernelSpec(ndim=3, **kw))
    jstride = jax.jit(lambda g: mt.ops.stride_grid(g, 2, 256))
    ji, jo, gi, go = jg, jg, pg, pg
    if geom == "down":
        jo, go = jstride(jg), mp.ops.stride_grid(pg, 2, 256)
    elif geom in ("up", "grow"):
        ji, gi = jstride(jg), mp.ops.stride_grid(pg, 2, 256)
    if geom == "grow":
        o = jspec.absolute_offsets(ji.stride)
        jo = jax.jit(lambda g: mt.ops.expand_grid(g, o, (1, 1, 1), 2048))(ji)
        go = mp.ops.expand_grid(gi, o, (1, 1, 1), 2048)
    for p, j in ((gi, ji), (go, jo)):
        np.testing.assert_array_equal(_np(p.coords), np.asarray(j.coords))
    f = (rng.randn(gi.capacity, cin) *
         _np(gi.valid)[:, None]).astype(np.float32)
    kern = (rng.randn(spec.volume, cin, cout) * 0.1).astype(np.float32)
    gout = (rng.randn(go.capacity, cout) *
            _np(go.valid)[:, None]).astype(np.float32)
    calls = []
    orig = jax_onehot._dkernel_fused
    monkeypatch.setattr(jax_onehot, "_dkernel_fused",
                        lambda *a: (calls.append(1), orig(*a))[1])
    dw = jax.grad(lambda k: jnp.vdot(mt.ops.fused_sparse_conv(
        jnp.asarray(f), k, ji, jo, jspec, tile=128, tw=128,
        compute_dtype=jnp.float32, interpret=True), gout))(jnp.asarray(kern))
    assert calls, "JAX took another dW than _dkernel_fused"
    return np.asarray(dw), _t(f), _t(gout), gi, go, spec


@pytest.mark.parametrize("name", list(KINDS))
def test_pairs_split_reduce_matches_jax_dkernel_fused(name, monkeypatch):
    """The pairs' dW in float32, with the kernel's own tile depth and split
    count at these shapes, against JAX's Pallas dW kernel
    (``_dkernel_fused``, interpret mode) at rtol = atol = 2e-5."""
    cin, cout = 4, 6
    ref, f, g, gi, go, spec = _jax_case(name, cin, cout, 2, monkeypatch)
    _, _, depth = fused_conv.dw_tile_shape(cin, cout)
    splits = fused_conv.dw_splits(go.capacity, cin, cout, spec.volume)
    assert splits > 1
    got = fused_conv._dkernel_pairs_plain(f, g, *_pairs(gi, go, spec),
                                          splits, depth, torch.float32)
    np.testing.assert_allclose(_np(got), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cin,cout,want", [
    (1, 1, (32, 32, 128)), (4, 4, (32, 32, 128)), (32, 33, (32, 64, 64)),
    (37, 70, (64, 128, 64)), (128, 4, (128, 32, 64)),
    (130, 96, (128, 128, 64)), (512, 512, (128, 128, 64))])
def test_dw_tile_shape(cin, cout, want):
    """Each of BI, BO the smallest of 32/64 that holds the width, else 128;
    BD 128 for the 32 x 32 tile, else 64."""
    assert fused_conv.dw_tile_shape(cin, cout) == want


@pytest.mark.parametrize("n_out,cin,cout,k,want", [
    (16384, 512, 512, 27, 1),    # 432 blocks fill the card
    (4096, 512, 512, 27, 1),
    (16384, 512, 512, 8, 2),     # 128 blocks; partials 2 x 8 MiB
    (32768, 512, 128, 8, 8),     # 32 blocks; partials 8 x 2 MiB
    (131072, 32, 32, 27, 20),    # 27 blocks -> 540
    (131072, 128, 32, 8, 64),    # 8 blocks, at most 64 splits
    (200, 4, 4, 27, 2),          # one chunk of 128 pairs a split
])
def test_dw_splits(n_out, cin, cout, k, want):
    assert fused_conv.dw_splits(n_out, cin, cout, k) == want
