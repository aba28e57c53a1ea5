"""Tests of the port's CUDA kernels (B1 forward, B2 dF, B3 dW of the fused
conv; B5 forward and dF pass, B6 dW of the brick conv) and of small VAE
and diffusion train steps through them; they need an NVIDIA GPU.

Marked ``cuda``: without a card each test skips (the decision is made
inside the test).  This file imports neither JAX nor the JAX package, so on
a machine with a card and no JAX it runs without the repository's
conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.ops import fused_conv
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
    once per backward.  Tolerance 1e-3·max|ref| + 1e-5 (summation order,
    and B3's fp32 atomics across row splits)."""
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
    1e-5 (summation order, and B6's fp32 atomics across blocks)."""
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
