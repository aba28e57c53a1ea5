"""B6's passes and plan (`csrc/brick_conv_dw.cu`, `ops/vol_conv.py`) on
the CPU, against loops written from the kernel's definitions (no JAX):

- ``live_tiles`` (the plain version of the live pass, in the GEMM's order)
  against a loop over the 4 x 4 x 16-cell tiles in ``tile_origin``'s
  order, on ragged volumes with empty, sparse and dense tiles, channels
  past Cout nonzero and negative zeros (a nonzero bit);
- ``_vol_conv_dw_splits_plain`` (the GEMM's split runs and the ordered
  reduce) against ``_vol_conv_dw_plain`` and against a loop over the
  splits' tiles and their halos, within 1e-6·max|ref| (float32, the sums
  in another order), for 1, 3, 7 splits and the plan's;
- ``dw_splits`` against a search over the rule's bounds on a table of
  shapes.
"""

import itertools

import numpy as np
import pytest
import torch

from mink_octtree_stablediffusion_tpu_torch.ops import vol_conv as vc

torch.set_num_threads(1)


def _origin(t, x, y, z):
    """``brick::tile_origin``: (b, x0, y0, z0) of tile t."""
    tx, ty, tz = vc.TILE
    nx, ny, nz = -(-x // tx), -(-y // ty), -(-z // tz)
    t, z0 = divmod(t, nz)
    t, y0 = divmod(t, ny)
    b, x0 = divmod(t, nx)
    return b, x0 * tx, y0 * ty, z0 * tz


def _live_loop(gvolp, cout):
    b, x, y, z = (gvolp.shape[0], gvolp.shape[1] - 2, gvolp.shape[2] - 2,
                  gvolp.shape[3] - 2)
    tx, ty, tz = vc.TILE
    bits = gvolp.view(torch.int16)
    out = []
    for t in range(vc.n_tiles(b, x, y, z)):
        i, x0, y0, z0 = _origin(t, x, y, z)
        box = bits[i, 1 + x0:1 + min(x, x0 + tx), 1 + y0:1 + min(y, y0 + ty),
                   1 + z0:1 + min(z, z0 + tz), :cout]
        if box.ne(0).any():
            out.append(t)
    return out


def _volumes(rng, b, x, y, z, cin, cout, occupancy):
    """Padded bf16 volumes (channels padded to 16, a zero shell) whose
    cells are occupied with probability ``occupancy`` (the same cells in
    both, as on a self-grid conv)."""
    occ = rng.rand(b, x, y, z) < occupancy
    f = rng.randn(b, x, y, z, cin).astype(np.float32) * occ[..., None]
    g = rng.randn(b, x, y, z, cout).astype(np.float32) * occ[..., None]
    return (vc.pad_volume(torch.from_numpy(f)),
            vc.pad_volume(torch.from_numpy(g)))


@pytest.mark.parametrize("shape,occupancy", [
    ((2, 6, 5, 21, 3, 5), 0.02), ((1, 8, 8, 32, 4, 4), 0.0),
    ((1, 9, 4, 17, 16, 20), 1.0), ((3, 4, 7, 16, 5, 9), 0.1)])
def test_live_tiles_match_loop(shape, occupancy):
    rng = np.random.RandomState(sum(shape))
    b, x, y, z, cin, cout = shape
    _, gvolp = _volumes(rng, b, x, y, z, cin, cout, occupancy)
    assert vc.live_tiles(gvolp, cout).tolist() == _live_loop(gvolp, cout)


def test_live_tiles_read_only_the_conv_channels_and_bits():
    """A value in a channel past Cout does not make a tile live; a
    negative zero (a nonzero bit) does, as in the kernel."""
    gvolp = vc.pad_volume(torch.zeros(1, 4, 4, 32, 5))
    gvolp[0, 1, 1, 1, 4] = 1.0  # channel 4, past Cout 3: tile 0 stays dead
    gvolp[0, 2, 3, 20, 2] = -0.0  # tile 1
    assert vc.live_tiles(gvolp, 3).tolist() == [1]
    assert vc.live_tiles(gvolp, 5).tolist() == [0, 1]
    assert _live_loop(gvolp, 3) == [1] and _live_loop(gvolp, 5) == [0, 1]


def _splits_loop(volp, gvolp, cin, cout, splits):
    """The GEMM's split runs tile by tile: each run's tiles in list order,
    each tile's cells times its 27 shifted halo slabs, float64; the runs
    summed in order."""
    b, x, y, z = (volp.shape[0], volp.shape[1] - 2, volp.shape[2] - 2,
                  volp.shape[3] - 2)
    tx, ty, tz = vc.TILE
    live = _live_loop(gvolp, cout)
    per = max(1, -(-len(live) // splits))
    f, g = volp.double(), gvolp.double()
    out = torch.zeros(27, cin, cout, dtype=torch.float64)
    for s in range(splits):
        part = torch.zeros_like(out)
        for t in live[s * per:(s + 1) * per]:
            i, x0, y0, z0 = _origin(t, x, y, z)
            ex, ey, ez = min(tx, x - x0), min(ty, y - y0), min(tz, z - z0)
            gt = g[i, 1 + x0:1 + x0 + ex, 1 + y0:1 + y0 + ey,
                   1 + z0:1 + z0 + ez, :cout].reshape(-1, cout)
            for k, (dx, dy, dz) in enumerate(itertools.product(range(3),
                                                               repeat=3)):
                h = f[i, x0 + dx:x0 + dx + ex, y0 + dy:y0 + dy + ey,
                      z0 + dz:z0 + dz + ez, :cin].reshape(-1, cin)
                part[k] += h.t() @ gt
        out += part
    return out


@pytest.mark.parametrize("shape,occupancy", [
    ((2, 6, 5, 21, 3, 5), 0.3), ((1, 9, 4, 17, 16, 20), 1.0),
    ((2, 8, 8, 16, 24, 40), 0.05), ((1, 4, 4, 16, 4, 4), 0.0)])
@pytest.mark.parametrize("splits", [1, 3, 7, None])
def test_split_partials_summed_in_order_match_plain(shape, occupancy,
                                                    splits):
    rng = np.random.RandomState(sum(shape) + (splits or 0))
    b, x, y, z, cin, cout = shape
    volp, gvolp = _volumes(rng, b, x, y, z, cin, cout, occupancy)
    splits = splits or vc.dw_splits(b, x, y, z, cin, cout)
    got = vc._vol_conv_dw_splits_plain(volp, gvolp, cin, cout, splits)
    ref = vc._vol_conv_dw_plain(volp, gvolp, cin, cout)
    tol = 1e-6 * float(ref.abs().max())
    assert got.dtype == torch.float32 and got.shape == (27, cin, cout)
    assert float((got - ref).abs().max()) <= tol
    loop = _splits_loop(volp, gvolp, cin, cout, splits)
    assert float((got.double() - loop).abs().max()) <= tol
    if occupancy == 0.0:
        assert torch.all(got == 0)


SHAPES = [(b, n, n, n, cin, cout)
          for b in (1, 4) for n in (8, 16, 32, 64)
          for cin, cout in ((1, 1), (4, 4), (5, 70), (32, 128), (128, 32),
                            (96, 17), (128, 128), (200, 300))]


def test_dw_plan_matches_a_search_over_its_bounds():
    """S: the largest count with (3 dx planes × 64-channel Cin tiles ×
    64-channel Cout tiles) · S blocks in one wave of DW_SMS, S ≤ tiles and
    S partials within DW_PARTIAL_BYTES; 1 where none is."""
    for b, x, y, z, cin, cout in SHAPES:
        cols = 3 * -(-cin // 64) * -(-cout // 64)
        tiles = b * -(-x // 4) * -(-y // 4) * -(-z // 16)
        assert vc.n_tiles(b, x, y, z) == tiles
        ok = [s for s in range(1, tiles + 1)
              if cols * s <= vc.DW_SMS and
              4 * s * 27 * cin * cout <= vc.DW_PARTIAL_BYTES]
        assert vc.dw_splits(b, x, y, z, cin, cout) == max(ok, default=1)
    # the shapes of the diffusion step and the VAE's brick route
    assert vc.dw_splits(4, 16, 16, 16, 4, 4) == 44
    assert vc.dw_splits(4, 64, 64, 64, 128, 128) == 9
    assert vc.dw_splits(4, 32, 32, 32, 128, 128) == 9
