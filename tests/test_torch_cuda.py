"""Tests of the port's CUDA kernels (B1 forward, B2 dF, B3 dW and its
passes of the fused conv; B5 forward and dF pass, B6 dW of the brick conv;
B4 and B7, the convs given a kernel map; B1's stages, B8/B9) and of small
VAE and diffusion train steps through them, of data parallelism on the
card (SyncBN and a DP step, two ranks sharing it over gloo, in processes
spawned from `torch_dp_worker.py`), of the hash-table route of unbounded
grids on the card, and of the UNet's forward replayed as a CUDA graph
against its eager forward; they need an NVIDIA GPU.

Marked ``cuda``: without a card each test skips (the decision is made
inside the test).  This file imports neither JAX nor the JAX package, so on
a machine with a card and no JAX it runs without the repository's
conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.ops import fused_conv
from mink_octtree_stablediffusion_tpu_torch.ops import onehot_conv
from mink_octtree_stablediffusion_tpu_torch.ops import pallas_conv
from mink_octtree_stablediffusion_tpu_torch.ops import vol_conv


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _grid(dev, n=600, cap=1024, ext=12, bsz=2, seed=0):
    rng = np.random.RandomState(seed)
    rows = []
    for b in range(bsz):
        c = np.unique(rng.randint(0, ext, (n, 3)), axis=0)
        rows.append(np.concatenate([np.full((len(c), 1), b, np.int32), c], 1))
    cpad, valid = mp.ops.pad_to_capacity(np.concatenate(rows), cap)
    grid, _, _ = mp.ops.make_grid(torch.as_tensor(cpad, device=dev),
                                  torch.as_tensor(valid, device=dev), cap, 1,
                                  bsz, extent=(ext,) * 3)
    return grid


def _check(features, kernel, in_grid, out_grid, spec):
    """Kernel vs plain version on the same bf16-rounded operands;
    tolerance 1e-3·max|ref| + 1e-5 (summation order only)."""
    before = fused_conv.fused_sparse_conv.launches
    got = mp.ops.fused_sparse_conv(features, kernel, in_grid, out_grid, spec)
    assert fused_conv.fused_sparse_conv.launches == before + 1
    offs, s_in, cells = fused_conv.conv_geometry(in_grid, spec)
    ref = fused_conv._fused_sparse_conv_plain(
        features.bfloat16().float(), kernel.bfloat16().float(),
        in_grid.flat_keys(), out_grid.coords, out_grid.valid, offs, s_in,
        cells, torch.float32)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    assert err <= 1e-3 * ref.abs().max().item() + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(1, 8), (4, 4), (37, 70), (96, 130)])
def test_kernel_k3s1_matches_plain(cin, cout):
    dev = _card()
    g = _grid(dev)
    spec = mp.ops.KernelSpec(3, 1, ndim=3)
    f = torch.randn(g.capacity, cin, device=dev) * g.valid[:, None]
    _check(f, torch.randn(27, cin, cout, device=dev) * 0.1, g, g, spec)


@pytest.mark.cuda
def test_kernel_strided_transpose_generative_empty_match_plain():
    dev = _card()
    g = _grid(dev)
    g2 = mp.ops.stride_grid(g, 2, 512)
    s3, t2 = (mp.ops.KernelSpec(3, 2, ndim=3),
              mp.ops.KernelSpec(2, 2, ndim=3, transpose=True))
    grown = mp.ops.expand_grid(g2, t2.absolute_offsets(g2.stride),
                               t2.out_stride(g2.stride), 4096)
    f1 = torch.randn(g.capacity, 5, device=dev) * g.valid[:, None]
    f2 = torch.randn(g2.capacity, 6, device=dev) * g2.valid[:, None]
    _check(f1, torch.randn(27, 5, 7, device=dev), g, g2, s3)
    _check(f2, torch.randn(8, 6, 9, device=dev), g2, g, t2)
    _check(f2, torch.randn(8, 6, 9, device=dev), g2, grown, t2)
    empty = mp.SparseGrid(coords=torch.full_like(g.coords,
                                                 mp.ops.INVALID_COORD),
                          valid=torch.zeros_like(g.valid), stride=g.stride,
                          batch_size=g.batch_size, extent=g.extent)
    out = mp.ops.fused_sparse_conv(torch.zeros(g.capacity, 5, device=dev),
                                   torch.randn(27, 5, 7, device=dev), empty,
                                   empty, mp.ops.KernelSpec(3, 1, ndim=3))
    assert torch.all(out == 0)


def _grids(dev):
    """(name, in_grid, out_grid, spec) of the four conv kinds."""
    g = _grid(dev)
    g2 = mp.ops.stride_grid(g, 2, 512)
    s3, t2 = (mp.ops.KernelSpec(3, 2, ndim=3),
              mp.ops.KernelSpec(2, 2, ndim=3, transpose=True))
    grown = mp.ops.expand_grid(g2, t2.absolute_offsets(g2.stride),
                               t2.out_stride(g2.stride), 4096)
    return [("k3s1", g, g, mp.ops.KernelSpec(3, 1, ndim=3)),
            ("k3s2", g, g2, s3), ("k2s2T", g2, g, t2),
            ("k2s2G", g2, grown, t2)]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(1, 8), (5, 7), (96, 130)])
def test_backward_kernels_match_plain(cin, cout):
    """dF (B2: the forward kernel, flipped, reading W transposed) and dW
    (B3) of ``FusedSparseConv`` on the card against their plain versions on
    the same bf16-rounded operands, on the four conv kinds; each launches
    once per backward.  Tolerance 1e-3·max|ref| + 1e-5 (summation order:
    the tensor cores' within a chunk of pairs, then B3's chunks and its
    ordered sum over row splits)."""
    dev = _card()
    for name, gi, go, spec in _grids(dev):
        f = (torch.randn(gi.capacity, cin, device=dev) *
             gi.valid[:, None]).requires_grad_()
        k = (torch.randn(spec.volume, cin, cout, device=dev) * 0.1
             ).requires_grad_()
        gout = torch.randn(go.capacity, cout, device=dev) * go.valid[:, None]
        counts = (fused_conv.fused_conv_dfeatures.launches,
                  fused_conv.fused_conv_dkernel.launches)
        out = mp.ops.fused_sparse_conv(f, k, gi, go, spec)
        out.backward(gout)
        assert (fused_conv.fused_conv_dfeatures.launches,
                fused_conv.fused_conv_dkernel.launches) == (
            counts[0] + 1, counts[1] + 1), name
        offs, s_in, cells = fused_conv.conv_geometry(gi, spec)
        f_offs, s_out, f_cells = fused_conv.flipped_geometry(go, offs)
        g16 = gout.bfloat16().float()
        f16, k16 = f.detach().bfloat16().float(), k.detach().bfloat16().float()
        ref_df = fused_conv._fused_sparse_conv_plain(
            g16, k16.transpose(1, 2), go.flat_keys(), gi.coords, gi.valid,
            f_offs, s_out, f_cells, torch.float32)
        ref_dk = fused_conv._dkernel_plain(
            f16, g16, gi.flat_keys(), go.coords, go.valid, offs, s_in, cells,
            torch.float32)
        torch.cuda.synchronize()
        for got, ref in ((f.grad, ref_df), (k.grad, ref_dk)):
            err = (got - ref).abs().max().item()
            assert err <= 1e-3 * ref.abs().max().item() + 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(5, 7), (96, 130)])
def test_launches_count_their_work_where_it_happens(cin, cout):
    """B1, B2 and B3, launched inside a profiling record (the backward's on
    the autograd engine's thread), count their work in the kernels: each
    launch's matched pairs and valid rows give the operations and bytes
    that ``benchmark/work.py::launch_work`` counts from its operands, on
    the four conv kinds, a K = 343 conv in three bands and a 2-D grid;
    with no record open nothing is recorded."""
    from benchmark import work
    from benchmark.entries import launches as bench_launches
    from mink_octtree_stablediffusion_tpu_torch.utils import profiling

    dev = _card()
    g, g2d = _grid(dev), _grid_2d(dev)
    convs = _grids(dev) + [
        ("k7", g, g, mp.ops.KernelSpec(7, 1, ndim=3)),
        ("2d", g2d, g2d, mp.ops.KernelSpec(3, 1, ndim=2))]
    for name, gi, go, spec in convs:
        f = (torch.randn(gi.capacity, cin, device=dev) *
             gi.valid[:, None]).requires_grad_()
        k = (torch.randn(spec.volume, cin, cout, device=dev) * 0.1
             ).requires_grad_()
        gout = torch.randn(go.capacity, cout, device=dev) * go.valid[:, None]
        profiling.clear_records()
        with bench_launches.recorded() as calls, profiling.recording(), \
                profiling.span("conv"):
            mp.ops.fused_sparse_conv(f, k, gi, go, spec).backward(gout)
        rec, = profiling.records()
        bands = len(fused_conv.offset_bands(spec.volume))
        assert [x.kind for x in rec.launches] == [c[0] for c in calls] == \
            ["B1"] * bands + ["B2"] * bands + ["B3"] * bands, name
        for x, call in zip(rec.launches, calls):
            assert x.pairs > 0, name
            assert (x.ops, x.bytes) == work.launch_work(*call), (name, x)
    profiling.clear_records()
    mp.ops.fused_sparse_conv(f, k, gi, go, spec).backward(gout)
    assert profiling.records() == []


def _fwd_bwd_check(cin, cout, gi, go, spec, name):
    """B1 (forward) and B2 (dF) of ``FusedSparseConv`` on the card, each
    launched once, against their plain versions on the same bf16-rounded
    operands; tolerance 1e-3·max|ref| + 1e-5 (summation order)."""
    dev = gi.coords.device
    # a generator of its own: the global stream other tests draw from is
    # left as it was
    gen = torch.Generator(device=dev).manual_seed(cin * 1000 + cout)
    f = (torch.randn(gi.capacity, cin, device=dev, generator=gen) *
         gi.valid[:, None]).requires_grad_()
    k = torch.randn(spec.volume, cin, cout, device=dev,
                    generator=gen) / np.sqrt(spec.volume * cin)
    gout = torch.randn(go.capacity, cout, device=dev,
                       generator=gen) * go.valid[:, None]
    before = (fused_conv.fused_sparse_conv.launches,
              fused_conv.fused_conv_dfeatures.launches)
    out = mp.ops.fused_sparse_conv(f, k, gi, go, spec)
    out.backward(gout)
    assert (fused_conv.fused_sparse_conv.launches,
            fused_conv.fused_conv_dfeatures.launches) == (
        before[0] + 1, before[1] + 1), name
    offs, s_in, cells = fused_conv.conv_geometry(gi, spec)
    f_offs, s_out, f_cells = fused_conv.flipped_geometry(go, offs)
    f16, k16 = f.detach().bfloat16().float(), k.bfloat16().float()
    ref = fused_conv._fused_sparse_conv_plain(
        f16, k16, gi.flat_keys(), go.coords, go.valid, offs, s_in, cells,
        torch.float32)
    ref_df = fused_conv._fused_sparse_conv_plain(
        gout.bfloat16().float(), k16.transpose(1, 2), go.flat_keys(),
        gi.coords, gi.valid, f_offs, s_out, f_cells, torch.float32)
    torch.cuda.synchronize()
    for got, want in ((out, ref), (f.grad, ref_df)):
        assert want.abs().max().item() > 0, name
        err = (got - want).abs().max().item()
        assert err <= 1e-3 * want.abs().max().item() + 1e-5, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(3, 4), (4, 64), (33, 129), (8, 256),
                                      (3, 512), (64, 33), (129, 65)])
def test_b1_b2_tile_edges(cin, cout):
    """B1 and B2 at the edges of the kernel's tiles (``tile_shape``): Cout
    on both sides of BN (32/64/128) and past one tile, Cin not a multiple
    of 8 or of the chunk BK, K of 27 (k3s1, k3s2), 1 (k1) and 8 (k2s2
    pinned transpose and generative), on 1,500-row grids (not a multiple of
    the 128-row tile) whose rows past ~560 are invalid (whole tiles of
    invalid rows, which exit at once)."""
    dev = _card()
    g = _grid(dev, n=300, cap=1500)
    assert not g.valid[-256:].any()
    g2 = mp.ops.stride_grid(g, 2, 700)
    s3, t2 = (mp.ops.KernelSpec(3, 2, ndim=3),
              mp.ops.KernelSpec(2, 2, ndim=3, transpose=True))
    grown = mp.ops.expand_grid(g2, t2.absolute_offsets(g2.stride),
                               t2.out_stride(g2.stride), 4000)
    for name, gi, go, spec in (
            ("k3s1", g, g, mp.ops.KernelSpec(3, 1, ndim=3)),
            ("k1", g, g, mp.ops.KernelSpec(1, 1, ndim=3)),
            ("k3s2", g, g2, s3), ("k2s2T", g2, g, t2),
            ("k2s2G", g2, grown, t2)):
        _fwd_bwd_check(cin, cout, gi, go, spec, name)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(1, 4), (3, 32), (33, 129), (64, 33),
                                      (512, 512)])
def test_b1_cast_pass_matches_plain(cin, cout):
    """The operand cast that B1's source runs before the conv (features,
    and the weight plain and transposed for dF) equals its plain versions
    ``pad_features`` and ``pack_weight`` exactly."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin * 1000 + cout)
    f = torch.randn(1000, cin, device=dev, generator=gen)
    for transpose in (False, True):
        k = torch.randn(8, cout if transpose else cin,
                        cin if transpose else cout, device=dev, generator=gen)
        fb, wp = fused_conv._launch_cast(f, k, transpose)
        torch.cuda.synchronize()
        bn, bk = fused_conv.tile_shape(cin, cout)
        assert torch.equal(fb, fused_conv.pad_features(f))
        assert torch.equal(wp, fused_conv.pack_weight(k, transpose, bn, bk))


@pytest.mark.cuda
def test_cast_passes_read_bf16_weights():
    """With bf16 parameter storage the kernels get bf16 weights: B1's cast
    pass (plain and transposed, for dF) and B5's pack pass (forward and
    mirrored) read them and give, bit for bit, the packs of the same
    weight in float32; B1 and B5 on the bf16 weight equal B1 and B5 on
    its float32 copy."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(11)
    f = torch.randn(1000, 40, device=dev, generator=gen)
    for transpose in (False, True):
        k = torch.randn(8, 40, 72, device=dev, generator=gen).bfloat16()
        if transpose:
            k = k.transpose(1, 2).contiguous()
        got = fused_conv._launch_cast(f, k, transpose)
        ref = fused_conv._launch_cast(f, k.float(), transpose)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    k = torch.randn(27, 24, 40, device=dev, generator=gen).bfloat16()
    for mirror in (False, True):
        assert torch.equal(vol_conv._launch_pack(k, mirror),
                           vol_conv._launch_pack(k.float(), mirror))
    g = _grid(dev)
    x = torch.randn(g.capacity, 24, device=dev, generator=gen) * \
        g.valid[:, None]
    spec = mp.ops.KernelSpec(3, 1, ndim=3)
    assert torch.equal(mp.ops.fused_sparse_conv(x, k, g, g, spec),
                       mp.ops.fused_sparse_conv(x, k.float(), g, g, spec))
    volp = vol_conv.pad_volume(torch.randn(1, 4, 4, 16, 24, device=dev,
                                           generator=gen))
    assert torch.equal(vol_conv.vol_conv_tiles(volp, k),
                       vol_conv.vol_conv_tiles(volp, k.float()))


def _b3_case(gi, go, spec, cin, cout, seed):
    """B3's operands on one conv: (features, cotangent, keys, output
    coordinates, valid mask, offsets, stride, cells), drawn from a
    generator of their own."""
    dev = gi.coords.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = torch.randn(gi.capacity, cin, device=dev,
                    generator=gen) * gi.valid[:, None]
    g = torch.randn(go.capacity, cout, device=dev,
                    generator=gen) * go.valid[:, None]
    return (f, g, gi.flat_keys(), go.coords, go.valid,
            *fused_conv.conv_geometry(gi, spec))


def _b3_check(ops, name):
    """B3 through its wrapper's launcher (one launch) against its plain
    version on the same bf16-rounded operands: 1e-3·max|ref| + 1e-5
    (summation order), with max|ref| > 0.  Returns the kernel's dW."""
    f, g = ops[:2]
    got = fused_conv._launch_dkernel(*ops, torch.bfloat16)
    ref = fused_conv._dkernel_plain(f.bfloat16().float(),
                                    g.bfloat16().float(), *ops[2:],
                                    torch.float32)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and ref.abs().max().item() > 0, name
    err = (got - ref).abs().max().item()
    assert err <= 1e-3 * ref.abs().max().item() + 1e-5, (name, err)
    return got


def _even_x_grid(dev, cap=1024):
    """A 2-instance 12³ grid of even x only: a k3s1 conv's offsets with an
    x shift have no pair."""
    rng = np.random.RandomState(5)
    rows = []
    for b in range(2):
        c = np.unique(rng.randint(0, 12, (300, 3)) * [2, 1, 1] % 12, axis=0)
        rows.append(np.concatenate([np.full((len(c), 1), b, np.int32), c], 1))
    cpad, valid = mp.ops.pad_to_capacity(np.concatenate(rows), cap)
    grid, _, _ = mp.ops.make_grid(torch.as_tensor(cpad, device=dev),
                                  torch.as_tensor(valid, device=dev), cap, 1,
                                  2, extent=(12,) * 3)
    return grid


def _invalid_grid(g):
    return mp.SparseGrid(coords=torch.full_like(g.coords,
                                                mp.ops.INVALID_COORD),
                         valid=torch.zeros_like(g.valid), stride=g.stride,
                         batch_size=g.batch_size, extent=g.extent)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(1, 32), (4, 4), (37, 70), (130, 96),
                                      (512, 512)])
def test_b3_tile_edges(cin, cout):
    """B3 at the edges of its tiles (``dw_tile_shape``: Cin and Cout below,
    at and past 32/64/128, not multiples of 8) on the four conv kinds (K 27
    for k3s1 and k3s2, 8 for k2s2T and k2s2G), on 1,500-row grids whose
    rows past ~560 are invalid, with one split (512→512 at K 27) and with
    several (``dw_splits``); the wrapper counts one launch."""
    dev = _card()
    g = _grid(dev, n=300, cap=1500)
    g2 = mp.ops.stride_grid(g, 2, 700)
    s3, t2 = (mp.ops.KernelSpec(3, 2, ndim=3),
              mp.ops.KernelSpec(2, 2, ndim=3, transpose=True))
    grown = mp.ops.expand_grid(g2, t2.absolute_offsets(g2.stride),
                               t2.out_stride(g2.stride), 4000)
    for name, gi, go, spec in (
            ("k3s1", g, g, mp.ops.KernelSpec(3, 1, ndim=3)),
            ("k3s2", g, g2, s3), ("k2s2T", g2, g, t2),
            ("k2s2G", g2, grown, t2)):
        ops = _b3_case(gi, go, spec, cin, cout, cin * 1000 + cout)
        _b3_check(ops, name)
        before = fused_conv.fused_conv_dkernel.launches
        fused_conv.fused_conv_dkernel(ops[0], ops[1], gi, go, *ops[5:],
                                      torch.bfloat16)
        assert fused_conv.fused_conv_dkernel.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(4, 4), (512, 512)])
def test_b3_offsets_without_pairs_and_invalid_rows(cin, cout):
    """On a grid of even x only, B3's dW is exactly zero at every offset
    with an x shift (no pair) and matches its plain version; on a grid
    whose rows are all invalid it is zero everywhere; with several splits
    (4→4) and with one (512→512)."""
    dev = _card()
    g = _even_x_grid(dev)
    spec = mp.ops.KernelSpec(3, 1, ndim=3)
    ops = _b3_case(g, g, spec, cin, cout, 7)
    got = _b3_check(ops, "even x")
    shifted = torch.as_tensor(ops[5][:, 0] != 0, device=dev)
    assert torch.all(got[shifted] == 0) and torch.any(got[~shifted] != 0)
    empty = _invalid_grid(g)
    ops = _b3_case(empty, empty, spec, cin, cout, 8)
    ops = (torch.randn_like(ops[0]), torch.randn_like(ops[1])) + ops[2:]
    assert torch.all(fused_conv._launch_dkernel(*ops, torch.bfloat16) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(4, 4), (130, 96), (512, 512)])
def test_b3_two_launches_are_bit_identical(cin, cout):
    """No atomics: two launches on the same operands give the same dW bit
    for bit, with several row splits (4→4, 130→96) and with one
    (512→512)."""
    dev = _card()
    g = _grid(dev, n=600, cap=4096, ext=16)
    ops = _b3_case(g, g, mp.ops.KernelSpec(3, 1, ndim=3), cin, cout, 11)
    first = fused_conv._launch_dkernel(*ops, torch.bfloat16)
    second = fused_conv._launch_dkernel(*ops, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_b3_passes_match_plain():
    """B3's cast pass equals ``dw_operands`` exactly, and its search, scan
    and compaction give ``pair_list``'s pairs exactly, on the four conv
    kinds, a grid with offsets without pairs and a grid of invalid rows."""
    dev = _card()
    g = _grid(dev, n=300, cap=1500)
    k3 = mp.ops.KernelSpec(3, 1, ndim=3)
    cases = _grids(dev)
    even = _even_x_grid(dev)
    cases += [("k3s1 1500", g, g, k3), ("even x", even, even, k3),
              ("invalid", _invalid_grid(even), _invalid_grid(even), k3)]
    for i, (name, gi, go, spec) in enumerate(cases):
        cin, cout = (3, 70) if i % 2 else (33, 8)
        ops = _b3_case(gi, go, spec, cin, cout, i)
        fb, gb = fused_conv._launch_dkernel_passes(*ops, "cast")
        want = fused_conv.dw_operands(*ops[:2])
        assert torch.equal(fb, want[0]) and torch.equal(gb, want[1]), name
        got = fused_conv._launch_dkernel_passes(*ops, "pairs")
        want = fused_conv.pair_list(*ops[2:])
        for a, b in zip(got, want):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_vae_train_step_on_card_gives_every_parameter_a_gradient():
    """The detached-graph trap: a train step of a small VAE on the card
    reaches every parameter, and every fused-route conv launched B1, B3
    and (where its input carries a gradient) B2."""
    dev = _card()
    from mink_octtree_stablediffusion_tpu_torch.train import vae as tv
    cap, res, b = 4096, 64, 2
    enc, dec = mp.serve.capacities(cap)
    vae = mp.models.VAE(channels=(8, 16, 32, 32, 4), encoder_capacities=enc,
                        decoder_capacities=dec, device=dev)
    state = mp.train.TrainState(vae, mp.train.vae_optimizer(
        vae.parameters()))
    step = mp.train.make_train_step(tv.build_loss_fn(
        input_capacity=cap, batch_size=b, resolution=res, kld_weight=1e-6,
        device=dev))
    ds = mp.data.SyntheticShapes(resolution=res, num_samples=b)
    batch = mp.data.collate_pointclouds([ds[i]["coords"] for i in range(b)],
                                        cap)[:3]
    before = [c.launches for c in (fused_conv.fused_sparse_conv,
                                   fused_conv.fused_conv_dfeatures,
                                   fused_conv.fused_conv_dkernel)]
    with mp.nn.record_routes() as routes:
        loss, _ = step(state, batch,
                       generator=torch.Generator(device=dev).manual_seed(0))
    after = [c.launches for c in (fused_conv.fused_sparse_conv,
                                  fused_conv.fused_conv_dfeatures,
                                  fused_conv.fused_conv_dkernel)]
    fused = [r for r in routes if r.branch == "fused"]
    assert [a - b for a, b in zip(after, before)] == [
        len(fused), sum(r.grad_in for r in fused), len(fused)]
    assert torch.isfinite(loss)
    for name, p in vae.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back():
    """On CUDA tensors the wrapper launches the kernel or raises: float32
    compute launches B1's float32 variant, K = 343 launches once per band
    of offsets (125, 125, 93), float16 compute (outside
    ``kernel_domain``) and float64 features raise, launching nothing."""
    dev = _card()
    g = _grid(dev)
    f = torch.randn(g.capacity, 4, device=dev)
    k = torch.randn(27, 4, 4, device=dev)
    spec = mp.ops.KernelSpec(3, 1, ndim=3)
    w = fused_conv.fused_sparse_conv
    before = w.launches
    mp.ops.fused_sparse_conv(f, k, g, g, spec, compute_dtype=torch.float32)
    assert w.launches == before + 1
    cube = mp.ops.KernelSpec(7, 1, ndim=3)
    mp.ops.fused_sparse_conv(f, torch.randn(343, 4, 4, device=dev), g, g,
                             cube)
    assert w.launches == before + 4
    with pytest.raises(NotImplementedError):
        mp.ops.fused_sparse_conv(f, k, g, g, spec,
                                 compute_dtype=torch.float16)
    with pytest.raises(ValueError):
        mp.ops.fused_sparse_conv(f.double(), k, g, g, spec)
    assert w.launches == before + 4


def _close_to(got, ref):
    """Kernel vs plain version on the same bf16 operands: 1e-3·max|ref| +
    1e-5 (the kernels sum the same float32 products in another order:
    tensor-core k16 steps, tiles and, for B6, splits)."""
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    assert err <= 1e-3 * ref.abs().max().item() + 1e-5, err


def _brick_counts():
    return (vol_conv.vol_conv_tiles.launches,
            vol_conv.vol_conv_dfeatures.launches,
            vol_conv.vol_conv_dw.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(4, 4), (32, 32), (128, 128),
                                      (5, 70), (96, 17)])
def test_brick_kernels_match_plain(cin, cout):
    """B5, its dF pass and B6 through ``brick_pallas_conv`` and its
    backward, each launched once, against their plain versions on the
    same bf16 volumes (the cotangent scattered as the backward does)."""
    dev = _card()
    g = _grid(dev, n=900, cap=2048, ext=16, bsz=2)
    f = (torch.randn(g.capacity, cin, device=dev) *
         g.valid[:, None]).requires_grad_()
    k = (torch.randn(27, cin, cout, device=dev) * 0.1).requires_grad_()
    gout = torch.randn(g.capacity, cout, device=dev) * g.valid[:, None]
    before = _brick_counts()
    out = mp.ops.brick_pallas_conv(f, k, g)
    out.backward(gout)
    assert [a - b for a, b in zip(_brick_counts(), before)] == [1, 1, 1]
    cells = [16, 16, 16]
    volp = vol_conv._scatter(f.detach(), g, cells, torch.bfloat16)
    gvolp = vol_conv._scatter(gout, g, cells, torch.bfloat16)
    _close_to(out, vol_conv._gather(vol_conv._vol_conv_plain(volp, k.detach()),
                                    g, cells))
    _close_to(f.grad, vol_conv._gather(vol_conv._vol_conv_plain(
        gvolp, k.detach(), mirror=True), g, cells))
    _close_to(k.grad, vol_conv._vol_conv_dw_plain(volp, gvolp, cin, cout))


@pytest.mark.cuda
def test_brick_conv_ragged_dense_and_empty_volumes():
    """B5 and B6 on dense random volumes whose sides are not multiples of
    the 4 x 4 x 16 tile (the edge masks), and on an all-zero volume (the
    skipped chunks and tiles still write zeros)."""
    dev = _card()
    vol = torch.randn(2, 5, 7, 19, 24, device=dev)
    volp = vol_conv.pad_volume(vol)
    k = torch.randn(27, 24, 40, device=dev) * 0.1
    _close_to(vol_conv.vol_conv_tiles(volp, k),
              vol_conv._vol_conv_plain(volp, k))
    gvolp = vol_conv.pad_volume(torch.randn(2, 5, 7, 19, 40, device=dev))
    _close_to(vol_conv.vol_conv_dw(volp, gvolp, 24, 40),
              vol_conv._vol_conv_dw_plain(volp, gvolp, 24, 40))
    _close_to(vol_conv.vol_conv_dfeatures(gvolp, k),
              vol_conv._vol_conv_plain(gvolp, k, mirror=True))
    zero = torch.zeros_like(volp)
    assert torch.all(vol_conv.vol_conv_tiles(zero, k) == 0)
    assert torch.all(vol_conv.vol_conv_dw(zero, gvolp, 24, 40) == 0)
    with pytest.raises(NotImplementedError):
        vol_conv.vol_conv_tiles(volp.half(), k)


def _b6_volumes(dev, shape, cin, cout, occupancy, seed,
                dtype=torch.bfloat16):
    """Padded input and cotangent volumes in ``dtype`` whose cells are
    occupied with probability ``occupancy`` (the same cells in both)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    occ = torch.rand(shape, device=dev, generator=gen) < occupancy
    f = torch.randn(*shape, cin, device=dev, generator=gen) * occ[..., None]
    g = torch.randn(*shape, cout, device=dev, generator=gen) * occ[..., None]
    return vol_conv.pad_volume(f, dtype), vol_conv.pad_volume(g, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("occupancy", [1.0, 0.01])
@pytest.mark.parametrize("cin,cout", [(4, 4), (128, 128), (24, 40)])
def test_b6_launches_are_bit_identical(cin, cout, occupancy):
    """B6 twice at the plan's split count and twice at other counts (1,
    and 3 with its reduce) on a dense and a sparse random volume: each
    pair equal bit for bit (no atomics), each count within tolerance of
    its plain version (``_vol_conv_dw_splits_plain``, the same split
    order) and of ``_vol_conv_dw_plain``."""
    dev = _card()
    shape = (2, 8, 12, 32)
    volp, gvolp = _b6_volumes(dev, shape, cin, cout, occupancy,
                              cin + cout)
    ref = vol_conv._vol_conv_dw_plain(volp, gvolp, cin, cout)
    plan = vol_conv.dw_splits(*shape, cin, cout)
    for splits in sorted({plan, 1, 3}):
        def run():
            out = torch.empty(27, cin, cout, device=dev)
            vol_conv._run_dw(volp, gvolp, cin, cout, out, "full", splits)
            return out
        a, b = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(a, b), splits
        _close_to(a, vol_conv._vol_conv_dw_splits_plain(volp, gvolp, cin,
                                                        cout, splits))
        _close_to(a, ref)
    assert torch.equal(vol_conv._launch_dw(volp, gvolp, cin, cout),
                       vol_conv._launch_dw(volp, gvolp, cin, cout))


@pytest.mark.cuda
def test_b6_dense_128_matches_plain():
    """B6 at 128→128 on a dense 4 x 32³ volume (every tile live, 9 splits
    of 56-57 tiles) against its plain version."""
    dev = _card()
    volp, gvolp = _b6_volumes(dev, (4, 32, 32, 32), 128, 128, 1.0, 7)
    assert vol_conv.dw_splits(4, 32, 32, 32, 128, 128) == 9
    _close_to(vol_conv.vol_conv_dw(volp, gvolp, 128, 128),
              vol_conv._vol_conv_dw_plain(volp, gvolp, 128, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [3, 16, 40])
def test_b6_live_list_matches_plain(cout):
    """The tiles B6's live pass flags (``_launch_dw_live``) equal to
    ``live_tiles`` on ragged volumes: sparse, empty, dense, a value only
    past Cout (not live) and a negative zero (live)."""
    dev = _card()
    for occupancy in (0.003, 0.0, 1.0):
        _, gvolp = _b6_volumes(dev, (2, 6, 5, 21), 4, 48, occupancy, cout)
        if occupancy == 0.0:
            gvolp[0, 1, 1, 1, cout] = 1.0
            gvolp[1, 6, 5, 21, 0] = -0.0
        assert torch.equal(vol_conv._launch_dw_live(gvolp, cout).cpu(),
                           vol_conv.live_tiles(gvolp, cout).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(4, 4), (4, 128), (128, 4),
                                      (128, 128)])
def test_brick_conv_tile_edges(cin, cout):
    """B5 and its dF pass at Cin 4 and 128 on dense random volumes whose
    x, y, z are not multiples of the 4 x 4 x 16 tile, on a volume whose
    halo chunks are partly zero (channel 16 onwards zero), and on an
    all-zero volume (no live chunk: the tile writes zeros)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin * 1000 + cout)
    vol = torch.randn(2, 6, 5, 21, cin, device=dev, generator=gen)
    volp = vol_conv.pad_volume(vol)
    k = torch.randn(27, cin, cout, device=dev,
                    generator=gen) / np.sqrt(27 * cin)
    _close_to(vol_conv.vol_conv_tiles(volp, k),
              vol_conv._vol_conv_plain(volp, k))
    gvolp = vol_conv.pad_volume(torch.randn(2, 6, 5, 21, cout, device=dev,
                                            generator=gen))
    _close_to(vol_conv.vol_conv_dfeatures(gvolp, k),
              vol_conv._vol_conv_plain(gvolp, k, mirror=True))
    part = volp.clone()
    part[..., 16:] = 0
    part[:, :, :, 9:] = 0
    _close_to(vol_conv.vol_conv_tiles(part, k),
              vol_conv._vol_conv_plain(part, k))
    zero = torch.zeros_like(volp)
    assert torch.all(vol_conv.vol_conv_tiles(zero, k) == 0)
    assert torch.all(vol_conv.vol_conv_dfeatures(torch.zeros_like(gvolp),
                                                 k) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(4, 4), (5, 70), (96, 17), (128, 128),
                                      (24, 200)])
def test_brick_pack_pass_matches_plain(cin, cout):
    """The weight pack that B5's source runs before the conv (forward, and
    mirrored for dF) equals its plain version ``pack_weight`` exactly."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin * 1000 + cout)
    k = torch.randn(27, cin, cout, device=dev, generator=gen)
    for mirror in (False, True):
        got = vol_conv._launch_pack(k, mirror)
        torch.cuda.synchronize()
        assert torch.equal(got, vol_conv.pack_weight(k, mirror)), mirror


def _close_f32(got, ref):
    """A float32 instantiation against its float32 plain version:
    2e-5·max|ref| (above float32 summation-order error, below what bf16 or
    TF32 rounding of the operands gives)."""
    if got.is_cuda:
        torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    assert err <= 2e-5 * ref.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(4, 4), (32, 32), (128, 128),
                                      (5, 70), (96, 17)])
def test_brick_f32_kernels_match_plain(cin, cout):
    """B5-f32, its dF pass and B6-f32 through ``brick_pallas_conv`` at
    float32 compute and its backward, each launched once, against their
    float32 plain versions on the same float32 volumes (the cotangent kept
    float32, as JAX's ``_brick_bwd`` at float32)."""
    dev = _card()
    g = _grid(dev, n=900, cap=2048, ext=16, bsz=2)
    f = (torch.randn(g.capacity, cin, device=dev) *
         g.valid[:, None]).requires_grad_()
    k = (torch.randn(27, cin, cout, device=dev) * 0.1).requires_grad_()
    gout = torch.randn(g.capacity, cout, device=dev) * g.valid[:, None]
    before = _brick_counts()
    out = mp.ops.brick_pallas_conv(f, k, g, compute_dtype=torch.float32)
    out.backward(gout)
    assert [a - b for a, b in zip(_brick_counts(), before)] == [1, 1, 1]
    cells = [16, 16, 16]
    volp = vol_conv._scatter(f.detach(), g, cells, torch.float32)
    gvolp = vol_conv._scatter(gout, g, cells, torch.float32)
    _close_f32(out, vol_conv._gather(vol_conv._vol_conv_plain(
        volp, k.detach()), g, cells))
    _close_f32(f.grad, vol_conv._gather(vol_conv._vol_conv_plain(
        gvolp, k.detach(), mirror=True), g, cells))
    _close_f32(k.grad, vol_conv._vol_conv_dw_plain(volp, gvolp, cin, cout))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(4, 4), (4, 128), (128, 4),
                                      (128, 128)])
def test_brick_f32_tile_edges(cin, cout):
    """B5-f32 and its dF pass (and B6-f32) at ``test_brick_conv_tile_edges``'
    shapes: dense ragged volumes, a partly zero halo, an all-zero volume;
    B5-f32 also on a bf16 weight (one weight term)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin * 1000 + cout)
    vol = torch.randn(2, 6, 5, 21, cin, device=dev, generator=gen)
    volp = vol_conv.pad_volume(vol, torch.float32)
    k = torch.randn(27, cin, cout, device=dev,
                    generator=gen) / np.sqrt(27 * cin)
    _close_f32(vol_conv.vol_conv_tiles(volp, k),
               vol_conv._vol_conv_plain(volp, k))
    kb = k.bfloat16()
    _close_f32(vol_conv.vol_conv_tiles(volp, kb),
               vol_conv._vol_conv_plain(volp, kb.float()))
    gvolp = vol_conv.pad_volume(torch.randn(2, 6, 5, 21, cout, device=dev,
                                            generator=gen), torch.float32)
    _close_f32(vol_conv.vol_conv_dfeatures(gvolp, k),
               vol_conv._vol_conv_plain(gvolp, k, mirror=True))
    _close_f32(vol_conv.vol_conv_dw(volp, gvolp, cin, cout),
               vol_conv._vol_conv_dw_plain(volp, gvolp, cin, cout))
    part = volp.clone()
    part[..., 16:] = 0
    part[:, :, :, 9:] = 0
    _close_f32(vol_conv.vol_conv_tiles(part, k),
               vol_conv._vol_conv_plain(part, k))
    zero = torch.zeros_like(volp)
    assert torch.all(vol_conv.vol_conv_tiles(zero, k) == 0)
    assert torch.all(vol_conv.vol_conv_dfeatures(torch.zeros_like(gvolp),
                                                 k) == 0)


@pytest.mark.cuda
def test_brick_f32_ragged_dense_and_empty_volumes():
    """B5-f32, dF-f32 and B6-f32 at ``test_brick_conv_ragged_dense_and_
    empty_volumes``' shapes, and on all-zero volumes."""
    dev = _card()
    volp = vol_conv.pad_volume(torch.randn(2, 5, 7, 19, 24, device=dev),
                               torch.float32)
    k = torch.randn(27, 24, 40, device=dev) * 0.1
    _close_f32(vol_conv.vol_conv_tiles(volp, k),
               vol_conv._vol_conv_plain(volp, k))
    gvolp = vol_conv.pad_volume(torch.randn(2, 5, 7, 19, 40, device=dev),
                                torch.float32)
    _close_f32(vol_conv.vol_conv_dw(volp, gvolp, 24, 40),
               vol_conv._vol_conv_dw_plain(volp, gvolp, 24, 40))
    _close_f32(vol_conv.vol_conv_dfeatures(gvolp, k),
               vol_conv._vol_conv_plain(gvolp, k, mirror=True))
    zero = torch.zeros_like(volp)
    assert torch.all(vol_conv.vol_conv_tiles(zero, k) == 0)
    assert torch.all(vol_conv.vol_conv_dw(zero, gvolp, 24, 40) == 0)
    assert torch.all(vol_conv.vol_conv_dw(volp, torch.zeros_like(gvolp), 24,
                                          40) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("occupancy", [1.0, 0.01])
@pytest.mark.parametrize("cin,cout", [(4, 4), (128, 128), (24, 40)])
def test_b6_f32_launches_are_bit_identical(cin, cout, occupancy):
    """B6-f32 twice at the plan's split count and twice at 1 and 3 splits:
    each pair equal bit for bit, each within 2e-5·max|ref| of the float32
    plain version."""
    dev = _card()
    shape = (2, 8, 12, 32)
    volp, gvolp = _b6_volumes(dev, shape, cin, cout, occupancy, cin + cout,
                              torch.float32)
    ref = vol_conv._vol_conv_dw_plain(volp, gvolp, cin, cout)
    plan = vol_conv.dw_splits(*shape, cin, cout, 3)
    for splits in sorted({plan, 1, 3}):
        def run():
            out = torch.empty(27, cin, cout, device=dev)
            vol_conv._run_dw(volp, gvolp, cin, cout, out, "full", splits)
            return out
        a, b = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(a, b), splits
        _close_f32(a, ref)
    assert torch.equal(vol_conv._launch_dw(volp, gvolp, cin, cout),
                       vol_conv._launch_dw(volp, gvolp, cin, cout))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(4, 4), (5, 70), (96, 17), (128, 128),
                                      (24, 200)])
def test_brick_f32_passes_match_plain(cin, cout):
    """The float32 instantiations' passes equal their plain versions
    exactly: the cast pass (``_launch_split`` against ``split_terms``) and
    the three-term pack (``_launch_pack(..., terms=3)`` against
    ``pack_weight(..., terms=3)``, forward and mirrored)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin * 1000 + cout)
    k = torch.randn(27, cin, cout, device=dev, generator=gen)
    for mirror in (False, True):
        got = vol_conv._launch_pack(k, mirror, terms=3)
        torch.cuda.synchronize()
        assert torch.equal(got, vol_conv.pack_weight(k, mirror, terms=3))
    vol = torch.randn(2, 7, 6, 5, 16 * (1 + cin // 16), device=dev,
                      generator=gen) * 10.0 ** torch.randint(
        -30, 30, (2, 7, 6, 5, 1), device=dev, generator=gen)
    assert torch.equal(vol_conv._launch_split(vol),
                       fused_conv.split_terms(vol, 3))


@pytest.mark.cuda
def test_empty_convs_count_no_launch():
    """A conv with no input channels (fused) or no output channels (brick)
    launches no kernel, and its wrapper counts none."""
    dev = _card()
    g = _grid(dev)
    before = fused_conv.fused_sparse_conv.launches
    out = mp.ops.fused_sparse_conv(torch.zeros(g.capacity, 0, device=dev),
                                   torch.zeros(27, 0, 7, device=dev), g, g,
                                   mp.ops.KernelSpec(3, 1, ndim=3))
    assert torch.all(out == 0)
    assert fused_conv.fused_sparse_conv.launches == before
    volp = vol_conv.pad_volume(torch.randn(1, 4, 4, 16, 8, device=dev))
    before = _brick_counts()
    assert vol_conv.vol_conv_tiles(
        volp, torch.zeros(27, 8, 0, device=dev)).numel() == 0
    assert _brick_counts() == before


@pytest.mark.cuda
def test_diffusion_train_step_with_brick_gate_on_card():
    """A small diffusion train step on the card with the brick gate on:
    brick-route convs launch B5, B6 and (where their input carries a
    gradient) the dF pass, fused-route convs B1, B3 and B2, and every UNet
    and NLL parameter gets a finite gradient."""
    dev = _card()
    from mink_octtree_stablediffusion_tpu_torch.train import diffusion as td
    cfg = td.parse_args(["--input_capacity", "4096", "--batch_size", "2",
                         "--vae_channel", "8", "16", "32", "32", "4",
                         "--unet_channel", "4", "8", "16", "16",
                         "--group", "4"])
    ds = mp.data.SyntheticShapes(resolution=128, num_samples=2,
                                 points_per_shape=1500)
    cpad, valid, _, _ = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(2)], 4096)
    mp.ops.enable_brick_conv(True)
    try:
        run = td.setup(cfg, dev)
        fused = (fused_conv.fused_sparse_conv,
                 fused_conv.fused_conv_dfeatures,
                 fused_conv.fused_conv_dkernel)
        brick = (vol_conv.vol_conv_tiles, vol_conv.vol_conv_dfeatures,
                 vol_conv.vol_conv_dw)
        before = [c.launches for c in fused + brick]
        with mp.nn.record_routes() as routes:
            loss, _ = run.step_fn(run.state, (cpad, valid),
                                  torch.Generator(device=dev).manual_seed(0))
        after = [c.launches for c in fused + brick]
    finally:
        mp.ops.enable_brick_conv(False)
    by = {b: [r for r in routes if r.branch == b] for b in ("fused", "brick")}
    assert by["brick"], {r.branch for r in routes}
    want = []
    for b in ("fused", "brick"):  # the frozen VAE's convs run no backward
        want += [len(by[b]), sum(r.grad_in for r in by[b]),
                 sum(r.grad_w for r in by[b])]
    assert [a - b for a, b in zip(after, before)] == want
    assert torch.isfinite(loss)
    for name, p in run.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def _map_counts():
    return (onehot_conv.onehot_sparse_conv.launches,
            pallas_conv.pallas_sparse_conv.launches)


def _close_bf16(got, ref):
    """A bf16 output against its plain version: the two float32 sums may
    round to neighbouring bf16 values, so one bf16 ulp of max|ref|,
    2^(⌊log₂ max|ref|⌋ − 7), + 1e-5."""
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(ref_max)) - 7) if ref_max > 0 else 0
    assert err <= ulp + 1e-5, err


def _close_f32(got, ref):
    """B7 on float32 features vs its float32 plain version: 2e-5·max|ref|,
    above float32 summation-order error and below what TF32 or bf16
    rounding of the operands would give."""
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    assert err <= 2e-5 * ref.abs().max().item(), err


def _maps(dev, g, gen):
    """Maps on ``g`` for the map-conv checks: k3 (27 offsets), the same
    shuffled with duplicated columns, k2 (8), k7 (343), and k3 with offset
    5 all missing and some indices past the rows (read as missing)."""
    def kmap(size):
        return mp.ops.kernel_map(g, g, mp.ops.KernelSpec(size, 1, ndim=3))
    nbr = kmap(3)
    perm = torch.randperm(nbr.shape[1], generator=gen, device=dev)
    shuffled = nbr[:, perm]
    shuffled[:, :100] = shuffled[:, 100:200]
    holes = nbr.clone()
    holes[5] = -1
    holes[7, ::9] = g.capacity + 3
    return {"k3": nbr, "k3_shuffled": shuffled.contiguous(), "k2": kmap(2),
            "k7": kmap(7), "k3_missing_offset": holes}


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(3, 32), (32, 32), (37, 70),
                                      (512, 512)])
def test_map_conv_kernels_match_plain(cin, cout):
    """B4 (bf16 operands) and B7 (float32-accurate products: on float32
    features, and on bf16 features against the float32-weight plain
    version) against their plain versions on the card, on k3, k2 and k7
    maps, a shuffled map with duplicated columns and a map with an
    all-missing offset; each launches once, and a second launch gives the
    same output bit for bit."""
    dev = _card()
    g = _grid(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    f = torch.randn(g.capacity, cin, device=dev,
                    generator=gen) * g.valid[:, None]
    for name, m in _maps(dev, g, gen).items():
        kv = m.shape[0]
        k = torch.randn(kv, cin, cout, device=dev,
                        generator=gen) / np.sqrt(kv * cin)
        before = _map_counts()
        got4 = mp.ops.onehot_sparse_conv(f, k, m)
        got7 = pallas_conv.pallas_sparse_conv(f, k, m)
        got7b = pallas_conv.pallas_sparse_conv(f.bfloat16(), k, m)
        assert [a - b for a, b in zip(_map_counts(), before)] == [1, 2], name
        assert got4.dtype == got7.dtype == torch.float32
        assert got7b.dtype == torch.bfloat16
        _close_to(got4, onehot_conv.map_conv_plain(f, k, m, torch.bfloat16))
        _close_f32(got7, onehot_conv.map_conv_plain(f, k, m, torch.float32))
        _close_bf16(got7b, onehot_conv.map_conv_plain(
            f.bfloat16(), k, m, torch.float32))
        assert torch.equal(got4, mp.ops.onehot_sparse_conv(f, k, m)), name
        assert torch.equal(got7, pallas_conv.pallas_sparse_conv(f, k, m))
        assert torch.equal(got7b, pallas_conv.pallas_sparse_conv(
            f.bfloat16(), k, m)), name


@pytest.mark.cuda
@pytest.mark.parametrize("source,dtype", [
    ("onehot_sparse_conv.cu", torch.float32),
    ("pallas_sparse_conv.cu", torch.float32),
    ("pallas_sparse_conv.cu", torch.bfloat16)])
def test_map_conv_passes_match_plain(source, dtype):
    """The cast pass (the bf16 terms of the features and the weight) and
    the pair lists (count, scan, compaction) of B4/B7 equal their plain
    versions ``map_conv_operands`` and ``map_pair_list`` exactly, on a k3
    map with an all-missing offset and indices past the rows; a bf16
    weight is split as its float32 value."""
    dev = _card()
    g = _grid(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    m = _maps(dev, g, gen)["k3_missing_offset"]
    f = (torch.randn(g.capacity, 37, device=dev, generator=gen) *
         g.valid[:, None]).to(dtype)
    for k in (torch.randn(27, 37, 70, device=dev, generator=gen),
              torch.randn(27, 37, 70, device=dev,
                          generator=gen).bfloat16()):
        terms = onehot_conv.MAP_TERMS[source][dtype]
        fb, wb = onehot_conv._launch_map_conv_passes(source, f, k, m, "cast")
        torch.cuda.synchronize()
        pfb, pwb = onehot_conv.map_conv_operands(
            f, k, terms, *onehot_conv.tile_shape(37, 70, terms))
        assert torch.equal(fb, pfb) and torch.equal(wb, pwb)
    got = onehot_conv._launch_map_conv_passes(source, f, k, m, "pairs")
    torch.cuda.synchronize()
    for a, b in zip(got, onehot_conv.map_pair_list(m, g.capacity)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_map_conv_offset_groups_are_bit_identical(monkeypatch):
    """With the partials' bound cut so that the offsets run in groups of 5
    (a float32 running sum kept between groups), B4 and B7 give the same
    output bit for bit as in one group: every row adds its partials in
    offset order either way."""
    dev = _card()
    g = _grid(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    m = _maps(dev, g, gen)["k3"]
    f = torch.randn(g.capacity, 64, device=dev,
                    generator=gen) * g.valid[:, None]
    k = torch.randn(27, 64, 96, device=dev, generator=gen) / np.sqrt(27 * 64)

    def convs():
        return (mp.ops.onehot_sparse_conv(f, k, m),
                pallas_conv.pallas_sparse_conv(f, k, m),
                pallas_conv.pallas_sparse_conv(f.bfloat16(), k, m))
    assert onehot_conv.map_groups(g.capacity, 96, 27) == 27
    whole = convs()
    monkeypatch.setattr(onehot_conv, "MAP_PARTIAL_BYTES",
                        5 * 4 * g.capacity * 96)
    assert onehot_conv.map_groups(g.capacity, 96, 27) == 5
    grouped = convs()
    torch.cuda.synchronize()
    for a, b in zip(whole, grouped):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_map_conv_kernels_empty_maps_and_bad_operands():
    """``N_out = 0`` launches nothing; an all-missing map gives zeros (one
    launch each); a bad map dtype or float64 features raise before any
    launch; B4 at float32 compute launches (B7's split-term
    instantiation) and counts as B4."""
    dev = _card()
    f = torch.randn(300, 8, device=dev)
    k = torch.randn(27, 8, 16, device=dev)
    before = _map_counts()
    for conv in (mp.ops.onehot_sparse_conv, pallas_conv.pallas_sparse_conv):
        out = conv(f, k, torch.zeros(27, 0, dtype=torch.int32, device=dev))
        assert out.shape == (0, 16)
    assert _map_counts() == before
    missing = torch.full((27, 256), -1, dtype=torch.int32, device=dev)
    for conv in (mp.ops.onehot_sparse_conv, pallas_conv.pallas_sparse_conv):
        out = conv(f, k, missing)
        torch.cuda.synchronize()
        assert out.shape == (256, 16) and torch.all(out == 0)
    assert [a - b for a, b in zip(_map_counts(), before)] == [1, 1]
    with pytest.raises(ValueError):
        mp.ops.onehot_sparse_conv(f, k, missing.long())
    with pytest.raises(ValueError):
        pallas_conv.pallas_sparse_conv(f.double(), k, missing)
    assert [a - b for a, b in zip(_map_counts(), before)] == [1, 1]
    out = mp.ops.onehot_sparse_conv(f, k, missing,
                                    compute_dtype=torch.float32)
    torch.cuda.synchronize()
    assert out.shape == (256, 16) and torch.all(out == 0)
    assert [a - b for a, b in zip(_map_counts(), before)] == [2, 1]


@pytest.mark.cuda
def test_onehot_conv_backward_on_card_matches_cpu():
    """``onehot_conv``'s backward (plain PyTorch) on the card against the
    same formula on the CPU; the forward launches B4 once."""
    dev = _card()
    g = _grid(dev)
    nbr = mp.ops.kernel_map(g, g, mp.ops.KernelSpec(3, 1, ndim=3))
    f = (torch.randn(g.capacity, 5, device=dev) *
         g.valid[:, None]).requires_grad_()
    k = (torch.randn(27, 5, 7, device=dev) * 0.1).requires_grad_()
    gout = torch.randn(g.capacity, 7, device=dev)
    before = _map_counts()
    onehot_conv.onehot_conv(f, k, nbr).backward(gout)
    assert _map_counts()[0] == before[0] + 1
    ref = onehot_conv._xla_backward(f.detach().cpu(), k.detach().cpu(),
                                    nbr.cpu(), gout.cpu())
    for got, r in zip((f.grad, k.grad), ref):
        _close_to(got.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(3, 32), (32, 32), (96, 130)])
def test_b1_stages_match_plain(cin, cout):
    """Each stage of B1 (B8/B9): ``full`` equals B1's output bit for bit
    and its plain version within 1e-3·max|ref| + 1e-5; ``search`` equals
    its plain version exactly; ``gather`` (bf16 rows, float32 sums) is
    within the same bound; ``empty`` is zeros."""
    dev = _card()
    g = _grid(dev)
    spec = mp.ops.KernelSpec(3, 1, ndim=3)
    f = torch.randn(g.capacity, cin, device=dev) * g.valid[:, None]
    k = torch.randn(27, cin, cout, device=dev) * 0.1
    offs, s_in, cells = fused_conv.conv_geometry(g, spec)
    plain = (f.bfloat16().float(), k.bfloat16().float(), g.flat_keys(),
             g.coords, g.valid, offs, s_in, cells)
    before = fused_conv.fused_conv_stage.launches
    got = {s: fused_conv.fused_conv_stage(f, k, g, g, spec, s)
           for s in fused_conv.STAGES}
    assert fused_conv.fused_conv_stage.launches == before + 4
    b1 = mp.ops.fused_sparse_conv(f, k, g, g, spec)
    torch.cuda.synchronize()
    assert torch.equal(got["full"], b1)
    _close_to(got["full"], fused_conv._stage_plain(*plain, torch.float32,
                                                   "full"))
    assert torch.equal(got["search"], fused_conv._stage_plain(
        *plain, torch.float32, "search"))
    _close_to(got["gather"], fused_conv._stage_plain(*plain, torch.float32,
                                                     "gather"))
    assert torch.all(got["empty"] == 0)


def _spawn_gloo_ranks(payload: dict, tmp_path, device="cuda") -> list:
    """Two ranks sharing the card in a gloo group (`torch_dp_worker.py`),
    running ``payload``'s jobs; → each rank's results."""
    import os

    import torch_dp_worker
    if device == "cuda":
        mp.utils.cuda_build.build()  # once, before the ranks load it
    torch.multiprocessing.start_processes(
        torch_dp_worker.run, args=(2, mp.parallel.free_port(), payload,
                                   str(tmp_path), device),
        nprocs=2, join=True, start_method="spawn")
    return [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt"),
                       weights_only=False) for r in range(2)]


@pytest.mark.cuda
def test_sync_batchnorm_on_card_over_gloo(tmp_path):
    """SyncBN on CUDA tensors of two ranks (valid rows differ) against the
    batch norm of their pooled rows, in float64 on the CPU: outputs and
    input gradients per rank, the scale/bias gradients summed over the
    ranks (each rank's own, before a step's mean), the running
    statistics; 1e-5."""
    _card()
    rng = np.random.RandomState(0)
    c, cap, tensors = 5, 512, []
    for n in (150, 90):
        rows = [np.concatenate([np.full((len(v), 1), b, np.int32), v], 1)
                for b in range(2)
                for v in [np.unique(rng.randint(0, 10, (n, 3)), axis=0)]]
        cpad, valid = mp.ops.pad_to_capacity(np.concatenate(rows), cap)
        feats = ((rng.randn(cap, c) * 2.0 + 1.0) * valid[:, None])
        tensors.append((cpad, valid, feats.astype(np.float32)))
    job = {"scale": (rng.rand(c) + 0.5).astype(np.float32),
           "bias": rng.randn(c).astype(np.float32), "extent": 10,
           "tensors": tensors,
           "gout": [rng.randn(cap, c).astype(np.float32) for _ in range(2)]}
    ranks = _spawn_gloo_ranks({"sync_bn": job}, tmp_path)

    # the reference: each rank's rows in its grid's order
    fs, vs = [], []
    for cpad, valid, feats in tensors:
        st = mp.sparse_tensor(torch.as_tensor(cpad), torch.as_tensor(feats),
                              capacity=cap, valid=torch.as_tensor(valid),
                              batch_size=2, extent=(10,) * 3)
        fs.append(st.features.double().requires_grad_())
        vs.append(st.valid.double()[:, None])
    w = torch.as_tensor(job["scale"]).double().requires_grad_()
    b = torch.as_tensor(job["bias"]).double().requires_grad_()
    n = sum(v.sum() for v in vs)
    mean = sum((f * v).sum(0) for f, v in zip(fs, vs)) / n
    var = sum((f ** 2 * v).sum(0) for f, v in zip(fs, vs)) / n - mean ** 2
    ys = [((f - mean) * torch.rsqrt(var + 1e-5) * w + b) * v
          for f, v in zip(fs, vs)]
    sum((y * torch.as_tensor(g).double()).sum()
        for y, g in zip(ys, job["gout"])).backward()
    for r, res in enumerate(ranks):
        got = res["sync_bn"]
        for key, want in (("y", ys[r]), ("df", fs[r].grad)):
            np.testing.assert_allclose(got[key], want.detach().numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(got["mean"], 0.1 * mean.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["var"], 0.9 + 0.1 * var.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    for key, want in (("dscale", w.grad), ("dbias", b.grad)):
        np.testing.assert_allclose(ranks[0]["sync_bn"][key] +
                                   ranks[1]["sync_bn"][key], want.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.cuda
def test_dp_vae_step_on_card_over_gloo(tmp_path):
    """One data-parallel step of a small SyncBN VAE with two ranks on the
    card (gloo; a different batch per rank): finite, the fused convs
    launched B1, and the two ranks' parameters and buffers equal bit for
    bit after the step."""
    _card()
    res, cap, b = 16, 256, 2
    ch, enc, dec = (4, 8, 8, 8, 2), (128, 64, 32, 32, 32), (16, 64, 128, 256)
    vae = mp.models.VAE(channels=ch, encoder_capacities=enc,
                        decoder_capacities=dec, latent_canvas=True,
                        device="cpu", seed=0)
    rng = np.random.RandomState(1)
    batches = []
    for n in (96, 60):
        vox = [np.unique(rng.randint(0, res, (n, 3)), axis=0)
               for _ in range(b)]
        cpad, valid = mp.ops.pad_to_capacity(
            mp.ops.batched_coordinates_np(vox), cap)
        batches.append((cpad, valid,
                        np.ones((cap, 1), np.float32) * valid[:, None]))
    job = {"cfg": {"channels": ch, "enc": enc, "dec": dec, "cap": cap,
                   "b": b, "res": res},
           "state": {n: t.numpy() for n, t in vae.state_dict().items()},
           "batches": batches,
           "eps": [rng.randn(enc[2], ch[4]).astype(np.float32)
                   for _ in range(2)],
           "canvas_noise": [rng.randn(b * (res // 8) ** 3, ch[4]).astype(
               np.float32) for _ in range(2)]}
    a, z = (r["vae_step"] for r in _spawn_gloo_ranks({"vae_step": job},
                                                      tmp_path))
    assert np.isfinite(a["loss"]) and a["loss"] == z["loss"]
    assert a["b1_launches"] > 0 and z["b1_launches"] == a["b1_launches"]
    for name, t in a["state"].items():
        np.testing.assert_array_equal(t, z["state"][name], err_msg=name)
    assert a["comm"]["bytes"] > 0


@pytest.mark.cuda
def test_hash_route_equals_sorted_route_on_card():
    """An unbounded grid's lookups on the card take the hash table; its
    rows equal the sorted search's on the same card (coordinates inside
    Morton's ±512-cell range) and the CPU's (the sorted route there), and
    its k3 kernel map the CPU's."""
    dev = _card()
    rng = np.random.RandomState(1)
    c = np.concatenate([rng.randint(0, 3, (3000, 1)),
                        rng.randint(-60, 60, (3000, 3))], 1).astype(np.int32)
    cpad, valid = mp.ops.pad_to_capacity(c, 4096)
    grid, _, _ = mp.ops.make_grid(torch.as_tensor(cpad, device=dev),
                                  torch.as_tensor(valid, device=dev), 4096,
                                  1, 3)
    assert mp.ops.lookup_route(grid, dev) == "hash"
    q = torch.as_tensor(np.concatenate([cpad, cpad + 1]), device=dev)
    qv = torch.as_tensor(np.concatenate([valid, valid]), device=dev)
    got = mp.ops.grid_lookup(grid, q, qv)
    ref = mp.ops.lookup_sorted(grid.coords, grid.valid, grid.stride, q, qv)
    assert torch.equal(got, ref) and int((got >= 0).sum()) > 0
    cpu = mp.ops.grid_lookup(mp.SparseGrid(grid.coords.cpu(),
                                           grid.valid.cpu(), (1, 1, 1), 3),
                             q.cpu(), qv.cpu())
    assert torch.equal(got.cpu(), cpu)
    spec = mp.ops.KernelSpec(3, 1, ndim=3)
    cpu_grid = mp.SparseGrid(grid.coords.cpu(), grid.valid.cpu(), (1, 1, 1),
                             3)
    assert torch.equal(mp.ops.kernel_map(grid, grid, spec).cpu(),
                       mp.ops.kernel_map(cpu_grid, cpu_grid, spec))


# -- the fused conv's whole domain: float32 compute, 2-D grids, K > 125 -------

F32_RTOL = 2e-5  # float32 compute vs float32 plain: B7's (``_close_f32``)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,w_bf16", [(1, 8, False), (5, 7, False),
                                             (96, 130, False),
                                             (40, 72, True)])
def test_float32_kernels_match_plain(cin, cout, w_bf16):
    """B1, B2 and B3 at float32 compute (split terms: (3, 3), or (3, 1) on
    a bf16 weight) against their float32 plain versions on the four conv
    kinds; each launches once, and the weight's gradient is B3's dW in the
    weight's dtype."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin * 100 + cout)
    for name, gi, go, spec in _grids(dev):
        f = (torch.randn(gi.capacity, cin, device=dev, generator=gen) *
             gi.valid[:, None]).requires_grad_()
        k = torch.randn(spec.volume, cin, cout, device=dev, generator=gen) \
            / np.sqrt(spec.volume * cin)
        if w_bf16:
            k = k.bfloat16()
        k.requires_grad_()
        gout = torch.randn(go.capacity, cout, device=dev, generator=gen) * \
            go.valid[:, None]
        counts = [w.launches for w in (fused_conv.fused_sparse_conv,
                                       fused_conv.fused_conv_dfeatures,
                                       fused_conv.fused_conv_dkernel)]
        out = mp.ops.fused_sparse_conv(f, k, gi, go, spec,
                                       compute_dtype=torch.float32)
        out.backward(gout)
        assert [w.launches for w in (fused_conv.fused_sparse_conv,
                                     fused_conv.fused_conv_dfeatures,
                                     fused_conv.fused_conv_dkernel)] == [
            c + 1 for c in counts], name
        offs, s_in, cells = fused_conv.conv_geometry(gi, spec)
        f_offs, s_out, f_cells = fused_conv.flipped_geometry(go, offs)
        kf = k.detach().float()
        _close_f32(out, fused_conv._fused_sparse_conv_plain(
            f.detach(), kf, gi.flat_keys(), go.coords, go.valid, offs, s_in,
            cells, torch.float32))
        _close_f32(f.grad, fused_conv._fused_sparse_conv_plain(
            gout, kf.transpose(1, 2), go.flat_keys(), gi.coords, gi.valid,
            f_offs, s_out, f_cells, torch.float32))
        # B3's float32 dW, before the autograd formula rounds it to the
        # weight's dtype
        dw = fused_conv._launch_dkernel(f.detach(), gout, gi.flat_keys(),
                                        go.coords, go.valid, offs, s_in,
                                        cells, torch.float32)
        ref_dw = fused_conv._dkernel_plain(
            f.detach(), gout, gi.flat_keys(), go.coords, go.valid, offs,
            s_in, cells, torch.float32)
        _close_f32(dw, ref_dw)
        assert torch.equal(k.grad, dw.to(k.dtype)), name


@pytest.mark.cuda
def test_float32_cast_passes_match_plain():
    """The float32 cast passes: B1's features and weight (plain and
    transposed; a bf16 weight as one term) and B3's f and g as three bf16
    terms each, equal to ``pad_features`` / ``pack_weight`` /
    ``dw_operands`` with their terms exactly."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    f = torch.randn(1000, 33, device=dev, generator=gen)
    for transpose in (False, True):
        for w_bf16 in (False, True):
            k = torch.randn(8, 129 if transpose else 33,
                            33 if transpose else 129, device=dev,
                            generator=gen)
            if w_bf16:
                k = k.bfloat16()
            ta, tb = fused_conv.operand_terms(torch.float32, w_bf16)
            fb, wp = fused_conv._launch_cast(f, k, transpose, torch.float32)
            torch.cuda.synchronize()
            bn, bk = fused_conv.tile_shape(33, 129, (ta, tb))
            assert torch.equal(fb, fused_conv.pad_features(f, ta))
            assert torch.equal(wp, fused_conv.pack_weight(k, transpose, bn,
                                                          bk, tb))
    g = _grid(dev)
    ops = _b3_case(g, g, mp.ops.KernelSpec(3, 1, ndim=3), 33, 70, 0)
    fb, gb = fused_conv._launch_dkernel_passes(*ops, "cast", torch.float32)
    want = fused_conv.dw_operands(*ops[:2], 3)
    assert torch.equal(fb, want[0]) and torch.equal(gb, want[1])


def _grid_2d(dev, n=400, cap=1024, ext=40, bsz=2, seed=0):
    rng = np.random.RandomState(seed)
    rows = []
    for b in range(bsz):
        c = np.unique(rng.randint(0, ext, (n, 2)), axis=0)
        rows.append(np.concatenate([np.full((len(c), 1), b, np.int32), c], 1))
    cpad, valid = mp.ops.pad_to_capacity(np.concatenate(rows), cap)
    grid, _, _ = mp.ops.make_grid(torch.as_tensor(cpad, device=dev),
                                  torch.as_tensor(valid, device=dev), cap, 1,
                                  bsz, extent=(ext, ext))
    return grid


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["bf16", "f32"])
def test_2d_kernels_match_plain(compute):
    """B1, B2 and B3 on 2-D grids (k3s1, k3s2, k2s2 pinned transpose and
    generative) against their plain versions: bf16 compute on the same
    bf16-rounded operands (1e-3·max|ref| + 1e-5), float32 compute on the
    float32 operands (2e-5·max|ref|)."""
    dev = _card()
    cd = torch.bfloat16 if compute == "bf16" else torch.float32
    g = _grid_2d(dev)
    g2 = mp.ops.stride_grid(g, 2, 512)
    s3, t2 = (mp.ops.KernelSpec(3, 2, ndim=2),
              mp.ops.KernelSpec(2, 2, ndim=2, transpose=True))
    grown = mp.ops.expand_grid(g2, t2.absolute_offsets(g2.stride),
                               t2.out_stride(g2.stride), 2048)
    gen = torch.Generator(device=dev).manual_seed(7)
    for name, gi, go, spec in (("k3s1", g, g, mp.ops.KernelSpec(3, 1,
                                                                ndim=2)),
                               ("k3s2", g, g2, s3), ("k2s2T", g2, g, t2),
                               ("k2s2G", g2, grown, t2)):
        f = (torch.randn(gi.capacity, 24, device=dev, generator=gen) *
             gi.valid[:, None]).requires_grad_()
        k = (torch.randn(spec.volume, 24, 40, device=dev, generator=gen) /
             np.sqrt(spec.volume * 24)).requires_grad_()
        gout = torch.randn(go.capacity, 40, device=dev, generator=gen) * \
            go.valid[:, None]
        before = fused_conv.fused_sparse_conv.launches
        out = mp.ops.fused_sparse_conv(f, k, gi, go, spec, compute_dtype=cd)
        out.backward(gout)
        assert fused_conv.fused_sparse_conv.launches == before + 1
        offs, s_in, cells = fused_conv.conv_geometry(gi, spec)
        f_offs, s_out, f_cells = fused_conv.flipped_geometry(go, offs)
        r = (lambda t: t.bfloat16().float()) if compute == "bf16" else \
            (lambda t: t)
        fd, kd, gd = r(f.detach()), r(k.detach()), r(gout)
        refs = (fused_conv._fused_sparse_conv_plain(
                    fd, kd, gi.flat_keys(), go.coords, go.valid, offs, s_in,
                    cells, torch.float32),
                fused_conv._fused_sparse_conv_plain(
                    gd, kd.transpose(1, 2), go.flat_keys(), gi.coords,
                    gi.valid, f_offs, s_out, f_cells, torch.float32),
                fused_conv._dkernel_plain(fd, gd, gi.flat_keys(), go.coords,
                                          go.valid, offs, s_in, cells,
                                          torch.float32))
        for got, ref, kern in zip((out, f.grad, k.grad), refs,
                                  ("B1", "B2", "B3")):
            if compute == "bf16":
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                assert err <= 1e-3 * ref.abs().max().item() + 1e-5, (
                    name, kern, err)
            else:
                _close_f32(got, ref)


@pytest.mark.cuda
def test_float32_compute_dtype_on_card_matches_cpu():
    """``ops.set_default_compute_dtype(torch.float32)`` on CUDA tensors
    (the float32 arm of ``train.check_bf16_training``): a conv layer's
    forward and both gradients, and one small VAE train step's BCE, on the
    card against the CPU, every conv on the fused route."""
    dev = _card()
    from mink_octtree_stablediffusion_tpu_torch.train import \
        check_bf16_training as cb
    g = _grid(dev)
    gen = torch.Generator().manual_seed(5)
    f = torch.randn(g.capacity, 12, generator=gen) * g.valid.cpu()[:, None]
    conv = mp.nn.SparseConv(12, 20, kernel_size=3, device="cpu")
    gout = torch.randn(g.capacity, 20, generator=gen)
    res = {}
    mp.ops.set_default_compute_dtype(torch.float32)
    try:
        for d in ("cpu", dev):
            c = conv.to(d)
            c.zero_grad()
            fi = f.detach().to(d).requires_grad_()
            x = mp.SparseTensor(grid=mp.SparseGrid(
                g.coords.to(d), g.valid.to(d), g.stride, g.batch_size,
                extent=g.extent), features=fi)
            with mp.nn.record_routes() as routes:
                out = c(x).features
            out.backward(gout.to(d))
            assert [r.branch for r in routes] == ["fused"]
            res[str(d)] = [t.detach().cpu() for t in (out, fi.grad,
                                                      c.kernel.grad)]
    finally:
        mp.ops.set_default_compute_dtype(None)
    for got, ref in zip(res[str(dev)], res["cpu"]):
        err = (got - ref).abs().max().item()
        assert err <= F32_RTOL * ref.abs().max().item(), err
    bce = {}
    init = cb.setup(small=True, device="cpu")["vae"].state_dict()
    eps = torch.randn(64, 4, generator=torch.Generator().manual_seed(1))
    for d in ("cpu", "cuda"):
        env = cb.setup(small=True, device=d)
        env["vae"].load_state_dict(init)  # a seed draws per device
        out = cb.run_arm(env, torch.float32, 1, 1,
                         eps=lambda i: eps.to(env["dev"]))
        assert not out["tf32"]
        assert "fused" in {r.branch for r in out["routes"]}
        bce[d] = out["curve"][0][1]
    assert abs(bce["cuda"] - bce["cpu"]) <= 1e-4 * bce["cpu"]


def _chip_smoke():
    """``chip_smoke.py`` from the checkout's root, as a module."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_2d_cases_on_card_match_cpu():
    """`tests/test_2d.py`'s two cases on CUDA tensors (the k3 conv on a full
    6x6 grid through the fused route, a k2 s2 down / transpose up round
    trip) against the same layers on the CPU, as ``chip_smoke.py``'s domain
    phase runs them (``domain_2d_cases``): B1 launches once a conv, the
    round trip's routes fused, within 1e-3·max|ref| + 1e-5 (bf16 compute
    on both: the card's default, its plain version on the CPU)."""
    cases = _chip_smoke().domain_2d_cases(mp, _card())
    assert set(cases) == {"k3_full_6x6", "down_up_round_trip"}
    assert all(c["ok"] for c in cases.values()), cases


@pytest.mark.cuda
def test_k7_cube_launches_in_offset_bands_on_card():
    """A k=7 cube (K = 343 > ``MAX_K``) on the card launches B1, B2 and B3
    once per band of offsets (``offset_bands``: 125, 125, 93; B1/B2 summed
    in offset order, B3's bands concatenated): forward and both gradients
    equal the CPU's plain versions within 1e-3·max|ref| + 1e-5 (bf16
    compute on both)."""
    dev = _card()
    g = _grid(dev)
    gen = torch.Generator().manual_seed(2)
    conv = mp.nn.SparseConv(6, 10, kernel_size=7, device="cpu")
    f = torch.randn(g.capacity, 6, generator=gen) * g.valid.cpu()[:, None]
    gout = torch.randn(g.capacity, 10, generator=gen)
    wrappers = (fused_conv.fused_sparse_conv, fused_conv.fused_conv_dfeatures,
                fused_conv.fused_conv_dkernel)
    res = {}
    mp.ops.set_default_compute_dtype(torch.bfloat16)
    try:
        for d in ("cpu", dev):
            c = conv.to(d)
            c.zero_grad()
            fi = f.detach().to(d).requires_grad_()
            x = mp.SparseTensor(grid=mp.SparseGrid(
                g.coords.to(d), g.valid.to(d), g.stride, g.batch_size,
                extent=g.extent), features=fi)
            before = [w.launches for w in wrappers]
            with mp.nn.record_routes() as routes:
                out = c(x).features
            out.backward(gout.to(d))
            assert [r.branch for r in routes] == ["fused"]
            after = [w.launches for w in wrappers]
            if d == dev:
                assert [a - b for a, b in zip(after, before)] == [3] * 3
            res[str(d)] = [t.detach().cpu() for t in (out, fi.grad,
                                                      c.kernel.grad)]
    finally:
        mp.ops.set_default_compute_dtype(None)
    for got, want in zip(res[str(dev)], res["cpu"]):
        _close_to(got, want)


@pytest.mark.cuda
def test_brick_gate_sends_float32_to_the_brick_kernel():
    """With the brick gate on, a k3 s1 conv takes the brick route at bf16
    and at float32 compute, launching B5 once and no fused kernel; at
    float32 (B5-f32) its output lies within 2e-5·max|ref| of the same conv
    on the CPU (the fused route's plain version in float32)."""
    dev = _card()
    g = _grid(dev, n=900, cap=2048, ext=16)
    conv = mp.nn.SparseConv(32, 32, kernel_size=3, device=dev)
    x = mp.SparseTensor(grid=g, features=torch.randn(
        g.capacity, 32, device=dev) * g.valid[:, None])
    mp.ops.enable_brick_conv(True)
    try:
        for cd in (torch.bfloat16, torch.float32):
            conv.compute_dtype = cd
            before = (vol_conv.vol_conv_tiles.launches,
                      fused_conv.fused_sparse_conv.launches)
            with mp.nn.record_routes() as routes:
                out = conv(x)
            torch.cuda.synchronize()
            assert [r.branch for r in routes] == ["brick"]
            after = (vol_conv.vol_conv_tiles.launches,
                     fused_conv.fused_sparse_conv.launches)
            assert [a - b for a, b in zip(after, before)] == [1, 0]
    finally:
        mp.ops.enable_brick_conv(False)
    conv.to("cpu")
    ref = conv(mp.SparseTensor(grid=_grid("cpu", n=900, cap=2048, ext=16),
                               features=x.features.cpu()))
    _close_f32(out.features.cpu(), ref.features)


@pytest.mark.cuda
def test_sharded_conv_on_card_matches_unsharded_slice():
    """Tensor parallelism through the kernels: a k3 conv holding the first
    half of a 32→64 kernel as its model shard (a 1-rank model group over
    gloo, so the gather and the dF sum run on CUDA tensors) against its
    unsharded twin, sliced: B1 at Cout 32 against Cout 64's first 32
    columns, B2 (dF, the twin's cotangent zero past them) and B3 (dW, the
    twin's first 32 columns); the bias added after the gather; each
    within 1e-3·max|ref| + 1e-5 (bf16 compute, fp32 sums in other tile
    orders)."""
    import torch.distributed as dist
    from mink_octtree_stablediffusion_tpu_torch.parallel import tp
    dev = _card()
    mp.utils.cuda_build.build()
    mp.parallel.initialize_distributed(
        f"127.0.0.1:{mp.parallel.free_port()}", 1, 0, backend="gloo")
    try:
        g = _grid(dev, n=900, cap=2048, ext=16)
        torch.manual_seed(0)
        full = mp.nn.SparseConv(32, 64, 3, use_bias=True, device=dev)
        half = mp.nn.SparseConv(32, 32, 3, use_bias=True, device=dev)
        with torch.no_grad():
            full.bias.normal_()
            half.kernel.copy_(full.kernel[:, :, :32])
            half.bias.copy_(full.bias[:32])
        half.model_shard = tp.ModelShard(dist.group.WORLD, 0, 1, 2)
        f = torch.randn(g.capacity, 32, device=dev) * g.valid[:, None]
        cot = torch.randn(g.capacity, 32, device=dev)
        count = {n: getattr(fused_conv, n) for n in (
            "fused_sparse_conv", "fused_conv_dfeatures", "fused_conv_dkernel")}
        out = {}
        for name, conv in (("full", full), ("half", half)):
            x = f.clone().requires_grad_()
            before = {n: c.launches for n, c in count.items()}
            tp.reset_comm()
            y = conv(mp.SparseTensor(grid=g, features=x)).features
            (y[:, :32] * cot).sum().backward()
            torch.cuda.synchronize()
            assert all(c.launches == before[n] + 1 for n, c in count.items())
            out[name] = (y[:, :32], x.grad, conv.kernel.grad[:, :, :32],
                         conv.bias.grad[:32], dict(tp.COMM))
    finally:
        dist.destroy_process_group()
    for got, ref in zip(out["half"][:4], out["full"][:4]):
        assert got.shape == ref.shape
        err = (got - ref).abs().max().item()
        assert err <= 1e-3 * ref.abs().max().item() + 1e-5, err
    comm = out["half"][4]
    assert comm["gather"]["calls"] == comm["dF_sum"]["calls"] == 1
    assert out["full"][4]["gather"]["calls"] == 0


# -- the UNet's forward as a CUDA graph (models/unet_graph.py) ---------------


def _unet_on_card(dev, **kw):
    return mp.models.UNet(channels=(4, 32, 64, 64), group=4, attn_max_len=256,
                          down_capacities=(512, 256, 128), device=dev, seed=1,
                          **kw)


def _latent_on_card(dev, seed, cap=1024, bsz=2, res=128):
    """A latent at stride 8 on a grid with a static extent: 300 random
    cells an instance, features N(0, 1) on the valid rows."""
    rng = np.random.RandomState(seed)
    vox = [np.unique(rng.randint(0, res // 8, (300, 3)), axis=0) * 8
           for _ in range(bsz)]
    cpad, valid = mp.ops.pad_to_capacity(mp.ops.batched_coordinates_np(vox),
                                         cap)
    grid, _, _ = mp.ops.make_grid(torch.as_tensor(cpad, device=dev),
                                  torch.as_tensor(valid, device=dev), cap, 8,
                                  bsz, extent=(res,) * 3)
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn(cap, 4, device=dev, generator=gen)
    return mp.SparseTensor(grid=grid, features=feats * grid.valid[:, None])


def _graph_counts(rec):
    return {n: rec.counter("unet.graph_" + n)
            for n in ("replay", "capture", "fallback")}


@pytest.mark.cuda
def test_unet_graph_equals_the_eager_forward_bit_for_bit():
    """Two requests (coordinate sets of one signature), 3 consecutive
    timesteps each: every graphed output equals the eager forward's bit
    for bit, lies on the caller's grid, aliases no input, and is unchanged
    by the replays after it; one capture (whose warm-up run answers the
    first call), five replays."""
    from mink_octtree_stablediffusion_tpu_torch.utils import profiling
    dev = _card()
    mp.utils.cuda_build.build()
    unet = _unet_on_card(dev)
    held = []
    profiling.clear_records()
    with torch.no_grad(), profiling.recording(), profiling.span("request"):
        for seed in (0, 1):
            x = _latent_on_card(dev, seed)
            x_in = x.features.clone()
            for t in (981, 961, 941):
                ts = torch.full((2,), t, dtype=torch.int32, device=dev)
                got = unet(x, ts)
                ref = unet.eager_forward(x, ts).features
                assert got.grid is x.grid
                assert got.features.data_ptr() != x.features.data_ptr()
                assert torch.equal(got.features, ref), (seed, t)
                held.append((got.features, ref.clone()))
            assert torch.equal(x.features, x_in)
    assert not torch.equal(held[0][1], held[3][1])  # two requests
    assert all(torch.equal(a, b) for a, b in held)
    rec = profiling.records()[-1]
    assert _graph_counts(rec) == {"replay": 5, "capture": 1, "fallback": 0}
    assert len(unet.graphs.graphs) == 1


@pytest.mark.cuda
def test_unet_graph_forward_hook_sees_each_steps_own_input_and_output():
    """``sample_latent`` over the graphed UNet: a forward hook keeps each
    step's input and output; each step's input differs, and the eager
    forward on it gives the kept output bit for bit; the final latent
    equals the eager sampler's."""
    dev = _card()
    mp.utils.cuda_build.build()
    unet = _unet_on_card(dev)
    x = _latent_on_card(dev, 2)
    ddim = mp.diffusion.DDIMScheduler.create()
    kept = []
    handle = unet.register_forward_hook(
        lambda m, a, o: kept.append((a[0], a[1], o)))
    with torch.no_grad():
        z = mp.diffusion.sample_latent(unet, ddim, x, num_inference_steps=4,
                                       init_noise=x.features)
    handle.remove()
    with torch.no_grad():
        ref = mp.diffusion.sample_latent(unet.eager_forward, ddim, x,
                                         num_inference_steps=4,
                                         init_noise=x.features)
        assert len(kept) == 4
        for i, (xi, ti, oi) in enumerate(kept):
            assert torch.equal(unet.eager_forward(xi, ti).features,
                               oi.features), i
            if i:
                assert not torch.equal(xi.features, kept[i - 1][0].features)
                assert not torch.equal(ti, kept[i - 1][1])
    assert torch.equal(z.features, ref.features)


@pytest.mark.cuda
def test_unet_graph_with_cfg_equals_eager():
    """Classifier-free guidance: the conditioned and the unconditioned
    call of a step share one signature and one graph, replayed twice a
    step (the first call captures it); each output equals the eager
    forward's and the sampled latent the eager sampler's, bit for bit."""
    from mink_octtree_stablediffusion_tpu_torch.utils import profiling
    dev = _card()
    mp.utils.cuda_build.build()
    unet = _unet_on_card(dev, with_cross_attn=True, cross_attention_dim=32,
                         cond_into_time=True)
    x = _latent_on_card(dev, 3)
    cond = torch.randn(2, 7, 32, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(4))
    ddim = mp.diffusion.DDIMScheduler.create()
    kept = []
    handle = unet.register_forward_hook(
        lambda m, a, o: kept.append((a[0], a[1], a[2], o)))
    profiling.clear_records()
    with torch.no_grad(), profiling.recording(), profiling.span("request"):
        z = mp.diffusion.sample_latent(unet, ddim, x, num_inference_steps=3,
                                       encoder_hidden_state=cond,
                                       guidance_scale=3.0,
                                       init_noise=x.features)
    handle.remove()
    with torch.no_grad():
        ref = mp.diffusion.sample_latent(unet.eager_forward, ddim, x,
                                         num_inference_steps=3,
                                         encoder_hidden_state=cond,
                                         guidance_scale=3.0,
                                         init_noise=x.features)
        assert len(kept) == 6
        for xi, ti, ci, oi in kept:
            assert torch.equal(unet.eager_forward(xi, ti, ci).features,
                               oi.features)
    assert torch.equal(z.features, ref.features)
    rec = profiling.records()[-1]
    assert _graph_counts(rec) == {"replay": 5, "capture": 1, "fallback": 0}


@pytest.mark.cuda
def test_unet_graph_replay_counts_the_launches_and_work_of_an_eager_call():
    """Inside an open record a replay adds the graph's B1 launches to
    ``fused_sparse_conv.launches`` and to the record, with the work its
    kernels counted, equal to an eager call's launch for launch; so does
    the call that captures the graph (its eager run on the side stream
    counts; the capture launches and counts nothing)."""
    from mink_octtree_stablediffusion_tpu_torch.utils import profiling
    dev = _card()
    mp.utils.cuda_build.build()
    unet = _unet_on_card(dev)
    x = _latent_on_card(dev, 5)
    ts = torch.full((2,), 500, dtype=torch.int32, device=dev)
    b1 = fused_conv.fused_sparse_conv

    def call(run):
        before = b1.launches
        profiling.clear_records()
        with torch.no_grad(), profiling.recording(), \
                profiling.span("unet.forward"):
            run(x, ts)
        rec, = profiling.records()
        return (b1.launches - before, rec.counter("fused_conv.B1"),
                [(w.kind, w.cin, w.cout, w.k, w.pairs, w.rows_in, w.rows_out)
                 for w in rec.launches])
    eager = call(unet.eager_forward)
    assert eager[0] == eager[1] == len(eager[2]) > 0
    first = call(unet)  # the side stream's eager run, then the capture
    replay = call(unet)
    assert first == replay == eager


@pytest.mark.cuda
def test_unet_graph_capture_failure_runs_eager_and_counts_as_eager(
        monkeypatch):
    """A capture that fails on the device (a planted B1 launcher that syncs
    its stream, illegal while the stream is captured): the call answers
    with the eager forward's output, and counts what one eager call counts
    (``fused_sparse_conv.launches``, the record's B1 launches with their
    work, the conv and attention routes, and ``chip_smoke.py``'s
    ``LaunchCapture`` shapes), with one ``unet.graph_fallback``; the
    stream is restored, the default CUDA generator draws again, and later
    calls of that signature run eager and count the same.  A later
    signature then captures (into a new pool) and replays as an eager
    call counts (the failed capture left nothing behind)."""
    from mink_octtree_stablediffusion_tpu_torch.utils import profiling
    dev = _card()
    mp.utils.cuda_build.build()
    launch, plant = fused_conv._launch, [True]

    def syncing(*a, **kw):
        if plant[0]:
            torch.cuda.current_stream().synchronize()
        return launch(*a, **kw)
    monkeypatch.setattr(fused_conv, "_launch", syncing)
    cap = _chip_smoke().LaunchCapture(mp)
    unet = _unet_on_card(dev)
    x = _latent_on_card(dev, 6)
    b1 = fused_conv.fused_sparse_conv
    stream = torch.cuda.current_stream()

    def call(run, path, ts):
        before = b1.launches
        profiling.clear_records()
        cap.at(path)
        with torch.no_grad(), mp.nn.record_routes() as routes, \
                mp.nn.record_attention() as attention, \
                profiling.recording(), profiling.span("unet.forward"):
            out = run(x, ts).features
        rec, = profiling.records()
        assert torch.cuda.current_stream() == stream
        return out, {
            "launches": b1.launches - before,
            "counted": rec.counter("fused_conv.B1"),
            "work": [(w.kind, w.cin, w.cout, w.k, w.pairs, w.rows_in,
                      w.rows_out) for w in rec.launches],
            "routes": list(routes), "attention": list(attention),
            "shapes": cap.counts.get(path, {})}, _graph_counts(rec)

    ts = torch.full((2,), 700, dtype=torch.int32, device=dev)
    with pytest.warns(UserWarning, match="could not be captured"), cap:
        ref, eager, _ = call(unet.eager_forward, "eager", ts)
        got, fell, graph = call(unet, "fallback", ts)
    assert eager["launches"] > 0 and eager["attention"]
    assert torch.equal(got, ref) and fell == eager
    assert graph == {"replay": 0, "capture": 0, "fallback": 1}
    assert torch.randn(8, device=dev).isfinite().all()
    with cap:
        for path in ("after", "after2"):
            got, later, graph = call(unet, path, ts)
            assert torch.equal(got, ref) and later == eager
            assert graph == {"replay": 0, "capture": 0, "fallback": 0}
        plant[0] = False  # a later signature (int64 timesteps) captures
        ts64 = ts.long()
        ref64, eager64, _ = call(unet.eager_forward, "eager64", ts64)
        got, first, graph = call(unet, "capture64", ts64)
        assert torch.equal(got, ref64) and first == eager64
        assert graph == {"replay": 0, "capture": 1, "fallback": 0}
        got, replay, graph = call(unet, "replay64", ts64)
        assert torch.equal(got, ref64) and replay == eager64
        assert graph == {"replay": 1, "capture": 0, "fallback": 0}
    assert len(unet.graphs.graphs) == 2


@pytest.mark.cuda
def test_unet_graph_engages_only_where_a_graph_can_stand_for_the_forward():
    """Gradients on, a grid with no static extent, or a hook on a
    submodule (which a replay would not call): the eager forward runs, the
    hook fires at every call, and no graph is kept.  With none of them one
    graph is captured; float32 compute switched on process-wide
    (``ops.set_default_compute_dtype``) captures another, whose outputs
    equal the eager forward's under that switch, and switched back the
    first graph answers again."""
    dev = _card()
    mp.utils.cuda_build.build()
    unet = _unet_on_card(dev)
    x = _latent_on_card(dev, 7)
    ts = torch.full((2,), 300, dtype=torch.int32, device=dev)
    unet(x, ts)  # gradients on
    assert len(unet.graphs.graphs) == 0
    g = x.grid
    unbounded = x.replace(grid=mp.ops.coords.SparseGrid(
        g.coords, g.valid, g.stride, g.batch_size, None))
    fired = []
    with torch.no_grad():
        unet(unbounded, ts)
        assert len(unet.graphs.graphs) == 0
        handle = unet.time_embedding.register_forward_hook(
            lambda *a: fired.append(1))
        try:
            unet(x, ts)
            unet(x, ts)
        finally:
            handle.remove()
        assert fired == [1, 1] and len(unet.graphs.graphs) == 0
        ref = unet.eager_forward(x, ts).features
        assert all(torch.equal(unet(x, ts).features, ref) for _ in range(2))
        assert len(unet.graphs.graphs) == 1
        mp.ops.set_default_compute_dtype(torch.float32)
        try:
            ref32 = unet.eager_forward(x, ts).features
            got32 = [unet(x, ts).features for _ in range(2)]
        finally:
            mp.ops.set_default_compute_dtype(None)
        assert len(unet.graphs.graphs) == 2 and not torch.equal(ref32, ref)
        assert all(torch.equal(got, ref32) for got in got32)
        assert torch.equal(unet(x, ts).features, ref)
    assert len(fired) == 2
