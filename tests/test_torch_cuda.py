"""Tests of the port's CUDA kernels (B1 forward, B2 dF, B3 dW) and of a
small VAE train step through them; they need an NVIDIA GPU.

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
