"""The operands the port's pipelined kernels read, cast and packed once per
call, against their definitions in plain PyTorch.

- B1/B2 (``ops/fused_conv.py``): ``pad_features`` (bf16 [N, CinF], CinF =
  Cin rounded up to 8, zero past Cin) and ``pack_weight`` (bf16 [K, CinW,
  CoutP], zero-padded to the kernel's tile, transposed per offset for
  dF), the plain versions of the cast pass in
  ``csrc/fused_sparse_conv.cu``, and ``tile_shape`` (the tile that sets
  the padding);
- B5 and its dF pass (``ops/vol_conv.py``): ``pack_weight`` (bf16 [Cout
  tiles, Cin chunks, 27, NT/8, 2, 8, 8], the K-major core matrices of each
  tap, the mirror W'[k] = W[26-k]ᵀ applied for dF), the plain version of
  the pack pass in ``csrc/brick_conv.cu``, and ``tile_cout``.

``tests/test_torch_cuda.py`` holds both passes equal to these on the card.
The casts round to nearest even, as the kernels' former in-kernel
``__float2bfloat16`` did, so the packed operands are bit-equal to what the
kernels multiplied before.  CPU only: no kernel is launched.
"""

import numpy as np
import pytest
import torch

from mink_octtree_stablediffusion_tpu_torch.ops import fused_conv
from mink_octtree_stablediffusion_tpu_torch.ops import vol_conv


def _randn(*shape, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


@pytest.mark.parametrize("cin", [1, 3, 4, 8, 33, 512])
def test_pad_features_is_bf16_zero_padded_to_8(cin):
    f = _randn(37, cin)
    got = fused_conv.pad_features(f)
    cinf = -(-cin // 8) * 8
    want = torch.zeros(37, cinf)
    want[:, :cin] = f
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == (37, cinf)
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("cin,cout", [(1, 4), (3, 32), (4, 64), (33, 129),
                                      (128, 256), (512, 512)])
@pytest.mark.parametrize("transpose", [False, True])
def test_fused_pack_weight_matches_definition(cin, cout, transpose):
    """``packed[k, i, j] = bf16(W[k, i, j])`` for i < Cin, j < Cout, zero
    elsewhere, with W the kernel or (dF) its per-offset transpose; the
    padded sizes are multiples of the tile (BN, BK)."""
    k = 27 if cin < 128 else 8
    kernel = _randn(k, cout, cin) if transpose else _randn(k, cin, cout)
    w = kernel.transpose(1, 2) if transpose else kernel
    bn, bk = fused_conv.tile_shape(cin, cout)
    got = fused_conv.pack_weight(kernel, transpose, bn, bk)
    cinw, coutp = -(-cin // bk) * bk, -(-cout // bn) * bn
    want = torch.zeros(k, cinw, coutp, dtype=torch.bfloat16)
    for o in range(k):
        for i in range(cin):
            want[o, i, :cout] = w[o, i].to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("cin,cout,want", [
    (1, 1, (32, 16)), (4, 4, (32, 16)), (3, 32, (32, 16)),
    (16, 33, (64, 16)), (17, 64, (64, 32)), (32, 65, (128, 32)),
    (33, 128, (128, 64)), (512, 512, (128, 64)), (960, 960, (128, 64))])
def test_tile_shape(cin, cout, want):
    """The smallest Cout tile of 32/64/128 that holds Cout (128 past it),
    the smallest Cin chunk of 16/32/64 that holds the 8-padded Cin (64 past
    it): the kernel's instantiations."""
    assert fused_conv.tile_shape(cin, cout) == want


def test_packed_operands_give_the_plain_conv():
    """The plain conv on the packed operands, cut back to the conv's
    widths, is the plain conv on bf16-rounded operands, bit for bit."""
    import mink_octtree_stablediffusion_tpu_torch as mp
    rng = np.random.RandomState(3)
    c = np.unique(rng.randint(0, 8, (200, 3)), axis=0)
    rows = np.concatenate([np.zeros((len(c), 1), np.int32), c], 1)
    cpad, valid = mp.ops.pad_to_capacity(rows, 256)
    grid, _, _ = mp.ops.make_grid(torch.as_tensor(cpad),
                                  torch.as_tensor(valid), 256, 1, 1,
                                  extent=(8,) * 3)
    spec = mp.ops.KernelSpec(3, 1, ndim=3)
    offs, s_in, cells = fused_conv.conv_geometry(grid, spec)
    f = _randn(256, 5) * grid.valid[:, None]
    kernel = _randn(27, 5, 7, seed=1)
    bn, bk = fused_conv.tile_shape(5, 7)
    fp = fused_conv.pad_features(f).float()[:, :5]
    wp = fused_conv.pack_weight(kernel, False, bn, bk).float()[:, :5, :7]
    args = (grid.flat_keys(), grid.coords, grid.valid, offs, s_in, cells,
            torch.float32)
    got = fused_conv._fused_sparse_conv_plain(fp, wp, *args)
    want = fused_conv._fused_sparse_conv_plain(
        f.bfloat16().float(), kernel.bfloat16().float(), *args)
    assert torch.equal(got, want)


def test_bf16_cast_rounds_to_nearest_even():
    """The wrappers' cast rounds as ``__float2bfloat16`` does: to nearest,
    ties to even."""
    x = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8),
                      1 + 2 ** -8 + 2 ** -20])
    got = fused_conv.pad_features(x[:, None])[:, 0].float()
    assert got.tolist() == [1.0, 1 + 2 ** -6, -1.0, 1 + 2 ** -7]


@pytest.mark.parametrize("cin,cout", [(4, 4), (5, 70), (32, 32), (96, 17),
                                      (128, 128), (24, 200)])
@pytest.mark.parametrize("mirror", [False, True])
def test_brick_pack_weight_matches_definition(cin, cout, mirror):
    """``packed[t, c, k, nb, kb, ni, ki] = bf16(W[k, 16c + 8kb + ki, NT·t +
    8nb + ni])``, zero past the conv's widths, with W the kernel or (dF)
    W'[k] = W[26-k]ᵀ; NT is ``tile_cout`` of W's Cout."""
    kernel = _randn(27, cin, cout)
    w = kernel.flip(0).transpose(1, 2) if mirror else kernel
    wcin, wcout = w.shape[1:]
    nt = vol_conv.tile_cout(wcout)
    got = vol_conv.pack_weight(kernel, mirror)
    nch, nct = -(-wcin // 16), -(-wcout // nt)
    assert got.shape == (nct, nch, 27, nt // 8, 2, 8, 8)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    full = torch.zeros(27, nch * 16, nct * nt)
    full[:, :wcin, :wcout] = w
    full = full.to(torch.bfloat16)
    for t in range(nct):
        for c in range(nch):
            for nb in range(nt // 8):
                for kb in range(2):
                    want = full[:, 16 * c + 8 * kb:16 * c + 8 * kb + 8,
                                nt * t + 8 * nb:nt * t + 8 * nb + 8]
                    assert torch.equal(got[t, c, :, nb, kb],
                                       want.transpose(1, 2))


@pytest.mark.parametrize("cout,want", [(1, 16), (16, 16), (17, 32),
                                       (32, 32), (33, 64), (64, 64),
                                       (65, 128), (128, 128), (200, 128)])
def test_tile_cout(cout, want):
    """One block covers Cout ≤ 128 whole; past 128, 128-wide tiles."""
    assert vol_conv.tile_cout(cout) == want


def test_brick_packed_weight_gives_the_plain_conv():
    """The plain brick conv (forward and dF) with the packed weight
    unpacked is the plain conv with the bf16-rounded kernel, bit for bit."""
    vol = _randn(1, 4, 4, 8, 5)
    volp = vol_conv.pad_volume(vol)
    kernel = _randn(27, 5, 70, seed=2)
    for mirror, v in ((False, volp),
                      (True, vol_conv.pad_volume(_randn(1, 4, 4, 8, 70)))):
        p = vol_conv.pack_weight(kernel, mirror).float()
        nct, nch, _, nb, _, _, _ = p.shape
        w = p.permute(2, 1, 4, 6, 0, 3, 5).reshape(27, nch * 16,
                                                   nct * nb * 8)
        w = w[:, :70, :5] if mirror else w[:, :5, :70]
        got = vol_conv._vol_conv_plain(v, w)
        want = vol_conv._vol_conv_plain(v, kernel.bfloat16().float(),
                                        mirror=mirror)
        assert torch.equal(got, want)
