"""The plain versions of the passes of B4's and B7's CUDA design
(`csrc/map_conv.cuh`) against loop definitions: the bf16 split terms and
the operands of the cast pass, the per-offset pair lists of the count,
scan and compaction passes, and the GEMM's partials summed in offset
order, group by group.  No kernel is launched: the card tests
(`tests/test_torch_cuda.py`) hold each pass equal to these.  Pure PyTorch,
a few seconds."""

import numpy as np
import pytest
import torch

from mink_octtree_stablediffusion_tpu_torch.ops import onehot_conv as oc

torch.set_num_threads(1)


def _map(kind, rng, k=27, n_out=300, n_in=200):
    """A map of ``kind``: ``banded`` (each row increasing over its valid
    entries, a fifth missing), ``shuffled`` (its columns permuted and a
    tenth replaced by copies of others), ``empty_offset`` (offset 3 with no
    pair, and indices past ``n_in`` that count as missing) or
    ``all_missing``."""
    nbr = np.sort(rng.randint(0, n_in, (k, n_out)), axis=1)
    nbr[rng.rand(k, n_out) < 0.2] = -1
    if kind == "shuffled":
        nbr = nbr[:, rng.permutation(n_out)]
        dst = rng.choice(n_out, n_out // 10, replace=False)
        nbr[:, dst] = nbr[:, rng.choice(n_out, len(dst))]
    elif kind == "empty_offset":
        nbr[3] = -1
        nbr[5, ::7] = n_in + rng.randint(0, 5, nbr[5, ::7].shape)
    elif kind == "all_missing":
        nbr[:] = -1
    return torch.as_tensor(nbr.astype(np.int32)), n_in


@pytest.mark.parametrize("kind", ["banded", "shuffled", "empty_offset",
                                  "all_missing"])
def test_map_pair_list_matches_loops(kind):
    """``map_pair_list``: offset k's pairs at ``starts[k]:starts[k + 1]``
    in ascending output row, ``pair_in`` their input rows, ``pos`` each
    (offset, output row)'s pair or -1; an index outside [0, n_in) is
    missing."""
    nbr, n_in = _map(kind, np.random.RandomState(0))
    starts, pair_in, pos = oc.map_pair_list(nbr, n_in)
    want_starts, want_in = [0], []
    want_pos = np.full(nbr.shape, -1, np.int32)
    for kk in range(nbr.shape[0]):
        for j in range(nbr.shape[1]):
            v = int(nbr[kk, j])
            if 0 <= v < n_in:
                want_pos[kk, j] = len(want_in)
                want_in.append(v)
        want_starts.append(len(want_in))
    assert starts.dtype == pair_in.dtype == pos.dtype == torch.int32
    assert starts.tolist() == want_starts
    assert pair_in.tolist() == want_in
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    if kind == "empty_offset":
        assert starts[4] == starts[3]
    if kind == "all_missing":
        assert pair_in.numel() == 0


def test_split_terms_reproduce_float32():
    """Three bf16 terms, each the rounding of what the earlier ones left,
    sum to the float32 value within 2⁻²⁴ of it, across exponents; one term
    is the plain bf16 rounding."""
    rng = np.random.RandomState(1)
    x = torch.as_tensor((rng.randn(4096) * 10.0 ** rng.uniform(
        -20, 20, 4096)).astype(np.float32))
    t = oc.split_terms(x, 3)
    assert t.dtype == torch.bfloat16 and t.shape == (3, 4096)
    assert torch.equal(t[0], x.to(torch.bfloat16))
    assert torch.equal(t[1], (x - t[0].float()).to(torch.bfloat16))
    err = (t.double().sum(0) - x.double()).abs()
    assert (err <= 2.0 ** -24 * x.double().abs()).all()
    assert torch.equal(oc.split_terms(x, 1)[0], x.to(torch.bfloat16))


@pytest.mark.parametrize("terms", [(1, 1), (1, 3), (3, 3)])
def test_map_conv_operands_layout(terms):
    """The cast pass's operands: the features' terms [TA, N, CinF] and the
    weight's [TB, K, CinW, CoutP], the split terms of each value in place,
    zero in the padding, at ``tile_shape``'s tile."""
    rng = np.random.RandomState(2)
    f = torch.as_tensor(rng.randn(50, 37).astype(np.float32))
    w = torch.as_tensor(rng.randn(8, 37, 70).astype(np.float32))
    bn, bk = oc.tile_shape(37, 70, terms)
    fb, wb = oc.map_conv_operands(f, w, terms, bn, bk)
    assert fb.shape == (terms[0], 50, 40)
    assert wb.shape == (terms[1], 8, -(-37 // bk) * bk, 128)
    for a in range(terms[0]):
        assert torch.equal(fb[a, :, :37], oc.split_terms(f, terms[0])[a])
    for b in range(terms[1]):
        assert torch.equal(wb[b, :, :37, :70], oc.split_terms(w, terms[1])[b])
    assert not fb[:, :, 37:].any() and not wb[:, :, 37:].any()
    assert not wb[:, :, :, 70:].any()


def test_tile_and_group_rules():
    """``tile_shape``: B1's (BN, BK), the Cin chunk cut to 32 with three
    weight terms and to 16 with three feature terms; ``map_groups``: the
    partials of a group (at most N_out pairs an offset) within
    ``MAP_PARTIAL_BYTES``, at least one offset, at most K; the terms of
    each source and dtype."""
    assert oc.tile_shape(3, 32, (1, 1)) == (32, 16)
    assert oc.tile_shape(512, 512, (1, 1)) == (128, 64)
    assert oc.tile_shape(512, 512, (1, 3)) == (128, 32)
    assert oc.tile_shape(512, 512, (3, 3)) == (128, 16)
    assert oc.map_groups(32768, 32, 27) == 27
    assert oc.map_groups(16384, 512, 27) == 27
    assert oc.map_groups(16384, 512, 343) == 32
    assert oc.map_groups(1 << 20, 1024, 27) == 1
    for n_out, cout, k in ((16384, 512, 343), (131072, 32, 27)):
        g = oc.map_groups(n_out, cout, k)
        assert 4 * g * n_out * cout <= oc.MAP_PARTIAL_BYTES
    assert oc.MAP_TERMS["pallas_sparse_conv.cu"] == {
        torch.float32: (3, 3), torch.bfloat16: (1, 3)}
    assert set(oc.MAP_TERMS["onehot_sparse_conv.cu"].values()) == {(1, 1)}


@pytest.mark.parametrize("kind", ["banded", "shuffled", "empty_offset",
                                  "all_missing"])
def test_pairs_plain_sums_in_offset_order(kind):
    """``_map_conv_pairs_plain`` (each pair's partial, then every row's
    partials added in offset order, ``group`` offsets at a time): one
    bf16 term each equals the bf16 plain version ``map_conv_plain`` within
    float32 summation order, and the groups leave the output bit for bit
    the same (each row's order is the offsets' order whatever the
    grouping)."""
    rng = np.random.RandomState(3)
    nbr, n_in = _map(kind, rng, k=8)
    f = torch.as_tensor(rng.randn(n_in, 19).astype(np.float32))
    w = torch.as_tensor(rng.randn(8, 19, 24).astype(np.float32))
    outs = [oc._map_conv_pairs_plain(f, w, nbr, (1, 1), g) for g in (1, 3, 8)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    ref = oc.map_conv_plain(f, w, nbr, torch.bfloat16)
    tol = 1e-6 * max(ref.abs().max().item(), 1.0)
    assert (outs[0] - ref).abs().max().item() <= tol
    if kind == "all_missing":
        assert not outs[0].any()
