"""The port's Morton codes and latent canvas against the JAX package.

`ops/morton.py` (``morton_encode``, ``morton_decode``,
``morton_encode_np``) and `ops/canvas.py` (``canvas_grid``,
``expand_to_canvas``) on the same numpy inputs, drawn from a seed: equal
exactly (integers, and features that are only moved).  With
``empty_noise_std > 0`` the noise lies only at the absent cells.
``VAE.to_canvas`` refuses a level-0 buffer smaller than the canvas in
both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import models as mm
import mink_octtree_stablediffusion_tpu_torch as mp

torch.set_num_threads(1)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("stride", [1, 2, 8, (1, 2, 4)])
def test_morton_matches_jax(stride):
    """Negative coordinates, coordinates off the stride's lattice, and
    coordinates past the 10-bit clip, exactly."""
    rng = np.random.RandomState(0)
    xyz = np.concatenate([rng.randint(-40, 40, (200, 3)),
                          rng.randint(-3000, 3000, (20, 3)),
                          np.array([[0, 0, 0], [-1, -1, -1], [511, -512, 7]])
                          ]).astype(np.int32)
    jstride = jnp.asarray(np.broadcast_to(np.asarray(stride, np.int32), 3))
    ref = np.array(mt.ops.morton_encode(jnp.asarray(xyz), jstride))
    got = _np(mp.ops.morton_encode(torch.as_tensor(xyz), stride))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32 and (got >= 0).all()
    np.testing.assert_array_equal(
        mp.ops.morton_encode_np(xyz, np.asarray(stride)),
        mt.ops.morton_encode_np(xyz, np.asarray(stride)))
    np.testing.assert_array_equal(mp.ops.morton_encode_np(
        xyz, np.asarray(stride)), ref)
    dec = _np(mp.ops.morton_decode(torch.as_tensor(got), 3))
    np.testing.assert_array_equal(
        dec, np.asarray(mt.ops.morton_decode(jnp.asarray(ref), 3)))
    if stride == 1:  # inside the clip the decode inverts the encode
        inside = (np.abs(xyz) < 512).all(1)
        np.testing.assert_array_equal(dec[inside], xyz[inside])


def test_morton_two_dims_matches_jax():
    xy = np.random.RandomState(1).randint(-5000, 5000, (100, 2)).astype(
        np.int32)
    ref = np.array(mt.ops.morton_encode(jnp.asarray(xy), 3))
    np.testing.assert_array_equal(
        _np(mp.ops.morton_encode(torch.as_tensor(xy), 3)), ref)
    np.testing.assert_array_equal(
        _np(mp.ops.morton_decode(torch.as_tensor(ref), 2)),
        np.asarray(mt.ops.morton_decode(jnp.asarray(ref), 2)))


@pytest.mark.parametrize("batch,res,stride", [(2, 16, 8), (3, 64, 8),
                                              (1, (24, 16, 40), (8, 4, 8)),
                                              (2, 20, 8)])
def test_canvas_grid_matches_jax(batch, res, stride):
    """Equal rows, and already in the port's canonical order: `make_grid`
    on the canvas's own coordinates returns them unchanged."""
    ref = mt.ops.canvas_grid(batch, res, stride)
    got = mp.ops.canvas_grid(batch, res, stride, device="cpu")
    np.testing.assert_array_equal(_np(got.coords), np.asarray(ref.coords))
    assert got.valid.all() and got.capacity == ref.capacity
    assert (got.stride, got.extent, got.batch_size) == (
        tuple(ref.stride), tuple(ref.extent), ref.batch_size)
    again, _, _ = mp.ops.make_grid(got.coords, got.valid, got.capacity,
                                   got.stride, batch, extent=got.extent)
    np.testing.assert_array_equal(_np(again.coords), _np(got.coords))


def _latents(rng, b=3, res=32, stride=8, cap=64, c=4):
    """The same sparse stride-8 latent in both packages (instance 1 holds
    no cells)."""
    cells = res // stride
    vox = [np.unique(rng.randint(0, cells, (9, 3)), axis=0) * stride
           for _ in range(b)]
    vox[1] = vox[1][:0]
    coords = mt.ops.batched_coordinates_np(vox)
    cpad, vpad = mt.ops.pad_to_capacity(coords, cap)
    feats = (rng.randn(cap, c) * vpad[:, None]).astype(np.float32)
    jlat = jax.jit(lambda co, f, v: mt.sparse_tensor(
        co, f, capacity=cap, batch_size=b, stride=stride, valid=v,
        extent=(res,) * 3))(jnp.asarray(cpad), jnp.asarray(feats),
                            jnp.asarray(vpad))
    plat = mp.sparse_tensor(torch.as_tensor(cpad), torch.as_tensor(feats),
                            capacity=cap, batch_size=b, stride=stride,
                            valid=torch.as_tensor(vpad), extent=(res,) * 3)
    np.testing.assert_array_equal(_np(plat.grid.coords),
                                  np.asarray(jlat.grid.coords))
    return jlat, plat


def test_expand_to_canvas_matches_jax(rng):
    jlat, plat = _latents(rng)
    jc = mt.ops.canvas_grid(3, 32, 8)
    pc = mp.ops.canvas_grid(3, 32, 8, device="cpu")
    ref = mt.ops.expand_to_canvas(jlat, jc)
    got = mp.ops.expand_to_canvas(plat, pc)
    assert got.grid is pc
    np.testing.assert_array_equal(_np(got.features), np.asarray(ref.features))
    present = (_np(mp.ops.grid_lookup(plat.grid, pc.coords, pc.valid)) >= 0)
    assert 0 < present.sum() < len(present)
    assert (_np(got.features)[~present] == 0).all()


def test_expand_to_canvas_noise_only_at_absent_cells(rng):
    """Present cells keep their features exactly; every absent cell holds
    the generator's N(0, std²) draw, and the draw is the generator's."""
    _, plat = _latents(rng)
    pc = mp.ops.canvas_grid(3, 32, 8, device="cpu")
    plain = _np(mp.ops.expand_to_canvas(plat, pc).features)
    got = _np(mp.ops.expand_to_canvas(
        plat, pc, empty_noise_std=0.5,
        generator=torch.Generator().manual_seed(4)).features)
    draw = 0.5 * torch.randn(plain.shape,
                             generator=torch.Generator().manual_seed(4))
    present = (_np(mp.ops.grid_lookup(plat.grid, pc.coords, pc.valid)) >= 0)
    np.testing.assert_array_equal(got[present], plain[present])
    np.testing.assert_array_equal(got[~present], _np(draw)[~present])
    assert (got[~present] != 0).all()
    with pytest.raises(ValueError, match="generator"):
        mp.ops.expand_to_canvas(plat, pc, empty_noise_std=0.5)


def test_vae_to_canvas_capacity_error(rng):
    """A level-0 buffer below batch·canvas cells (3·4³ = 192) fails in
    both packages; one that holds them gives the same canvas latent."""
    jlat, plat = _latents(rng)
    kw = dict(channels=(4, 8, 8, 8, 4),
              encoder_capacities=(64, 64, 64, 64, 64))
    jsmall = mm.VAE(decoder_capacities=(128, 256, 256, 256),
                    latent_canvas=True, **kw)
    psmall = mp.models.VAE(decoder_capacities=(128, 256, 256, 256),
                           latent_canvas=True, device="cpu", **kw)
    with pytest.raises(AssertionError, match="decoder_capacities"):
        jsmall.apply({}, jlat, method=jsmall.to_canvas)
    with pytest.raises(ValueError, match="decoder_capacities"):
        psmall.to_canvas(plat)
    jvae = mm.VAE(decoder_capacities=(192, 256, 256, 256),
                  latent_canvas=True, **kw)
    pvae = mp.models.VAE(decoder_capacities=(192, 256, 256, 256),
                         latent_canvas=True, device="cpu", **kw)
    ref = jvae.apply({}, jlat, method=jvae.to_canvas)
    got = pvae.to_canvas(plat)
    np.testing.assert_array_equal(_np(got.grid.coords),
                                  np.asarray(ref.grid.coords))
    np.testing.assert_array_equal(_np(got.features), np.asarray(ref.features))


def test_vae_forward_canvas_branch(rng):
    """`VAE.forward` with ``latent_canvas``: in ``.eval()`` the sampled
    latent goes onto the canvas with zeros at the empty cells; in
    ``.train()`` the empty cells take N(0, canvas_noise_std²) from the
    generator passed in (the draw after the reparameterisation's ``eps``),
    and no generator is refused."""
    res, cap, b = 32, 1024, 2
    vox = [np.unique(rng.randint(0, res, (300, 3)), axis=0) for _ in range(b)]
    cpad, valid = mp.ops.pad_to_capacity(
        mt.ops.batched_coordinates_np(vox), cap)
    st = mp.sparse_tensor(torch.as_tensor(cpad),
                          torch.as_tensor(valid[:, None].astype(np.float32)),
                          capacity=cap, batch_size=b,
                          valid=torch.as_tensor(valid), extent=(res,) * 3)
    vae = mp.models.VAE(channels=(4, 8, 8, 8, 4),
                        encoder_capacities=(512, 256, 128, 128, 128),
                        decoder_capacities=(128, 256, 512, 1024),
                        latent_canvas=True, canvas_noise_std=0.5,
                        device="cpu")
    with torch.no_grad():
        mean, log_var = vae.encode(st)
        eps = torch.randn(log_var.features.shape,
                          generator=torch.Generator().manual_seed(1))
        z_sparse = mean.with_features(
            mean.features + torch.exp(0.5 * log_var.features) * eps)
        *_, z = vae(st, st.grid, eps=eps)
        assert z.capacity == b * 4 ** 3 and z.grid.valid.all()
        np.testing.assert_array_equal(_np(z.features),
                                      _np(vae.to_canvas(z_sparse).features))
        vae.train()
        with pytest.raises(ValueError, match="generator"):
            vae(st, st.grid, eps=eps)
        *_, zt = vae(st, st.grid, generator=torch.Generator().manual_seed(2))
        mean, log_var = vae.encode(st)  # on the batch's statistics
        g = torch.Generator().manual_seed(2)
        eps2 = torch.randn(log_var.features.shape, generator=g)
        ref = vae.to_canvas(mean.with_features(
            mean.features + torch.exp(0.5 * log_var.features) * eps2), g)
    present = _np(mp.ops.grid_lookup(mean.grid, z.grid.coords,
                                     z.grid.valid)) >= 0
    assert 0 < present.sum() < len(present)
    np.testing.assert_array_equal(_np(zt.features), _np(ref.features))
    assert (_np(zt.features)[~present] != 0).all()
