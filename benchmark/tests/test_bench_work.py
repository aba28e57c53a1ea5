"""The yardstick's counts: matched pairs against a brute-force count,
model FLOPs of a tiny MinkUNet and a tiny VAE against hand sums."""

import itertools

import numpy as np
import torch

from benchmark import work
from benchmark.reference import sparse as sp


def conv_pair_count(coords: np.ndarray, k: int = 3) -> int:
    """Brute force: (in, out) pairs of a k-cube conv on one voxel set."""
    s = set(map(tuple, np.unique(coords, axis=0)))
    lo = (k - 1) // 2
    return sum((x + dx, y + dy, z + dz) in s
               for dx, dy, dz in itertools.product(range(-lo, k - lo),
                                                   repeat=3)
               for (x, y, z) in s)


def _cloud(seed, n=300, res=12):
    return np.random.RandomState(seed).randint(0, res, (n, 3))


def test_launch_pairs_match_brute_force():
    for seed in range(3):
        xyz = np.unique(_cloud(seed), axis=0)
        res = 12
        keys = np.sort((xyz[:, 0] * res + xyz[:, 1]) * res + xyz[:, 2])
        pad = 7
        in_keys = torch.tensor(np.concatenate(
            [keys, np.full(pad, work.INT32_MAX)]), dtype=torch.int32)
        coords = np.concatenate([np.zeros((len(xyz), 1), int), xyz], 1)
        out = torch.tensor(np.concatenate(
            [coords, np.full((pad, 4), 1 << 14)]), dtype=torch.int32)
        valid = torch.arange(len(out)) < len(xyz)
        offs = np.array(list(itertools.product((-1, 0, 1), repeat=3)))
        got = work.launch_pairs(in_keys, out, valid, offs, (1, 1, 1),
                                (res,) * 3)
        assert got == conv_pair_count(xyz)


def test_launch_work_counts_each_operand_once():
    in_keys = torch.tensor([0, 1, work.INT32_MAX], dtype=torch.int32)
    out = torch.tensor([[0, 0, 0, 0], [0, 0, 0, 1], [16384] * 4],
                       dtype=torch.int32)
    valid = torch.tensor([True, True, False])
    offs = np.array([[0, 0, 0], [0, 0, 1]])
    w = torch.zeros(2, 4, 8)
    ops, moved = work.launch_work("B1", (3, 4), w, in_keys, out, valid, offs,
                                  (1, 1, 1), (4, 4, 4))
    assert ops == 2 * 4 * 8 * 3  # pairs (0,0) (0,+z) (1,0)
    assert moved == (2 * 4 + 2 * 8) * 4 + w.numel() * 4 + 2 * 4 + 2 * 16
    ops3, _ = work.launch_work("B3", (3, 4), torch.Size([3, 8]), in_keys,
                               out, valid, offs, (1, 1, 1), (4, 4, 4))
    assert ops3 == ops
    assert work.bound_seconds(989e12, 0) == 1.0


def _pairs_same(xyz, stride, extent, k):
    """Brute force on a lattice of ``stride``."""
    s = set(map(tuple, xyz))
    lo = (k - 1) // 2
    d = [(a * stride, b * stride, c * stride) for a, b, c in
         itertools.product(range(-lo, k - lo), repeat=3)]
    return sum((x + dx, y + dy, z + dz) in s for dx, dy, dz in d
               for (x, y, z) in s)


def test_minkunet_flops_by_hand():
    """One instance, one block a stage: stem, four k2 s2 convs, eight
    stages, four transposes and the head, summed by hand."""
    xyz = np.unique(_cloud(1, 400, 16), axis=0)
    coords = torch.tensor(np.concatenate(
        [np.zeros((len(xyz), 1), int), xyz], 1))
    planes, init, cin0, cout = [4, 4, 8, 8, 8, 8, 4, 4], 4, 3, 3
    got = work.minkunet_train_flops(
        coords, extent=16, batch=1, in_channels=cin0,
        init_dim=init, planes=planes, layers=[1] * 8, out_channels=cout)
    levels = [xyz]
    for i in range(4):
        s = 2 ** (i + 1)
        levels.append(np.unique(levels[-1] // s * s, axis=0))

    def down_pairs(fine, coarse, s):  # k2 offsets {0, s/2}
        f = set(map(tuple, fine))
        h = s // 2
        return sum((x + a, y + b, z + c) in f for (x, y, z) in coarse
                   for a, b, c in itertools.product((0, h), repeat=3))
    fl = _pairs_same(xyz, 1, 16, 5) * cin0 * init
    cin = init
    for i in range(1, 5):
        s = 2 ** i
        fl += down_pairs(levels[i - 1], levels[i], s) * cin * cin
        p = planes[i - 1]
        fl += _pairs_same(levels[i], s, 16, 3) * (cin * p + p * p)
        fl += len(levels[i]) * cin * p if cin != p else 0
        cin = p
    skips = [planes[2], planes[1], planes[0], init]
    for j, i in enumerate((4, 5, 6, 7)):
        s = 2 ** (3 - j)
        fl += down_pairs(levels[3 - j], levels[4 - j], 2 * s) * cin * planes[i]
        c2, p = planes[i] + skips[j], planes[i]
        fl += _pairs_same(levels[3 - j], s, 16, 3) * (c2 * p + p * p)
        fl += len(levels[3 - j]) * c2 * p
        cin = p
    fl += len(xyz) * cin * cout
    assert got == 3 * 2 * fl


def test_vae_flops_count_the_forced_cells():
    """A single voxel: every level holds one cell, and every k3 conv has
    one pair; the decoder's generative heads make 8 children (each k3
    conv on them: 8 × 8 pairs) of which the one on the target is kept."""
    coords = torch.tensor([[0, 5, 9, 2]])
    ch = [2, 3, 4, 4, 2]
    got = work.vae_train_flops(coords, extent=16, batch=1, channels=ch)
    enc = sum(c_in * c + 2 * c * c for c_in, c in zip([1] + ch[:-1], ch))
    enc += 2 * ch[4] * ch[4]
    d = ch[::-1]
    dec = d[0] * d[1] + 2 * d[1] * d[1] + d[1]
    for lvl in (1, 2, 3):
        dec += 8 * d[lvl] * d[lvl + 1] + 2 * 64 * d[lvl + 1] ** 2 \
            + 8 * d[lvl + 1]
    assert got == 3 * 2 * (enc + dec)


def test_reference_counts_conv_pairs():
    g = sp.make_grid(torch.tensor([[0, 0, 0, 0], [0, 0, 0, 1]]), 1, 4, 1)
    w = torch.zeros(27, 2, 3)
    with sp.counting() as c:
        sp.conv_same(torch.zeros(2, 2), w, g)
    assert c[0] == 2 * 4 * 2 * 3  # 4 pairs
