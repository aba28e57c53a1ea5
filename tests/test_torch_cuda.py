"""Tests of the port's CUDA kernels; they need an NVIDIA GPU.

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
