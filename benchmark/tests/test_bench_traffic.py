"""The one traffic generator: every mix repeats for a seed, differs
across seeds, and gives every seed the same voxel counts."""

import glob
import os

import numpy as np
import pytest

from benchmark import traffic

MIXES = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(traffic.HERE, "traffic", "*.json")))


def _flat(batches):
    return [s.coords for b in batches for s in b]


@pytest.mark.parametrize("name", MIXES)
def test_mix_repeats_for_a_seed_and_differs_across_seeds(name):
    mix = traffic.load_mix(name)
    a = traffic.make_batches(mix, 2 ** 33 + 5)
    b = traffic.make_batches(mix, 2 ** 33 + 5)
    c = traffic.make_batches(mix, 7)
    assert all(np.array_equal(x, y) for x, y in zip(_flat(a), _flat(b)))
    assert not all(np.array_equal(x, y) for x, y in zip(_flat(a), _flat(c)))
    counts = sorted(sum(len(s.coords) for s in bt) for bt in a)
    assert counts == sorted(sum(len(s.coords) for s in bt) for bt in c)


@pytest.mark.parametrize("name", MIXES)
def test_mix_fits_its_buffers_and_grid(name):
    mix = traffic.load_mix(name)
    extent = mix.get("extent", mix.get("resolution"))
    for batch in traffic.make_batches(mix, 11):
        n = sum(len(s.coords) for s in batch)
        assert n <= mix["capacity"]
        assert n <= mix.get("max_batch_len", n)
        for s in batch:
            assert s.coords.min() >= 0 and s.coords.max() < extent
            assert len(np.unique(s.coords, axis=0)) == len(s.coords)
        coords, valid, feats, labels = traffic.collate(batch, mix["capacity"])
        assert valid.sum() == n and coords.shape == (mix["capacity"], 4)


def test_shapes_are_closed_surfaces():
    """Every voxel of a sphere's shell has a face neighbour on it: the
    surface was sampled densely enough to have no holes."""
    rng = np.random.RandomState(0)
    v = traffic.shape("sphere", 8000, 128, 10.0, rng)
    s = set(map(tuple, v))
    lonely = sum(all((x + dx, y + dy, z + dz) not in s
                     for dx, dy, dz in ((1, 0, 0), (-1, 0, 0), (0, 1, 0),
                                        (0, -1, 0), (0, 0, 1), (0, 0, -1)))
                 for x, y, z in v)
    assert len(v) <= 8000 and lonely == 0


def test_rooms_are_labelled_floor_wall_furniture():
    mix = traffic.load_mix("room-2cm")
    room = traffic.make_batches(mix, 3)[0][0]
    assert set(np.unique(room.labels)) == {0, 1, 2}
    assert (room.coords[room.labels == 0][:, 2] == 0).all()
    assert room.feats.shape == (len(room.coords), 3)
