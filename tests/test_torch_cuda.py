"""Tests of the port's CUDA kernels (B1 forward, B2 dF, B3 dW and its
passes of the fused conv; B5 forward and dF pass, B6 dW of the brick conv;
B4 and B7, the convs given a kernel map; B1's stages, B8/B9) and of small
VAE and diffusion train steps through them; they need an NVIDIA GPU.

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
    """On CUDA tensors the wrapper launches the kernel or raises."""
    dev = _card()
    g = _grid(dev)
    f = torch.randn(g.capacity, 4, device=dev)
    k = torch.randn(27, 4, 4, device=dev)
    spec = mp.ops.KernelSpec(3, 1, ndim=3)
    with pytest.raises(NotImplementedError):
        mp.ops.fused_sparse_conv(f, k, g, g, spec,
                                 compute_dtype=torch.float32)
    with pytest.raises(ValueError):
        mp.ops.fused_sparse_conv(f.double(), k, g, g, spec)


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
        vol_conv.vol_conv_tiles(volp.float(), k)


def _b6_volumes(dev, shape, cin, cout, occupancy, seed):
    """Padded bf16 input and cotangent volumes whose cells are occupied
    with probability ``occupancy`` (the same cells in both)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    occ = torch.rand(shape, device=dev, generator=gen) < occupancy
    f = torch.randn(*shape, cin, device=dev, generator=gen) * occ[..., None]
    g = torch.randn(*shape, cout, device=dev, generator=gen) * occ[..., None]
    return vol_conv.pad_volume(f), vol_conv.pad_volume(g)


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
            f, k, terms, *onehot_conv.map_tile_shape(37, 70, terms))
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
    launch each); a bad map dtype, a float32 compute dtype for B4 or
    float64 features raise before any launch."""
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
    with pytest.raises(NotImplementedError):
        mp.ops.onehot_sparse_conv(f, k, missing, compute_dtype=torch.float32)
    assert [a - b for a, b in zip(_map_counts(), before)] == [1, 1]


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
