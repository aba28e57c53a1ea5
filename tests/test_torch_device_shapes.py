"""The port's on-device procedural shapes against the JAX package.

- Each primitive's geometry, given the same draws (made in JAX with JAX's
  key splits and passed in): within 1e-6·max|ref|; this includes the
  rotation, whose Householder QR follows LAPACK's sign convention as
  ``jnp.linalg.qr`` on the CPU does.
- ``pack_voxels`` exactly, with an overflowing and a padded capacity.
- ``procedural_batch``: its layout, and, by design distribution-only
  (a ``torch.Generator`` is another stream than ``jax.random``), the mean
  voxel count per class of 16 shapes at resolution 32 within 15% of
  JAX's.
- One ``train.generalize --stream_device`` step on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mink_octtree_stablediffusion_tpu.data import device_shapes as jds
from mink_octtree_stablediffusion_tpu_torch.data import device_shapes as pds
from mink_octtree_stablediffusion_tpu_torch.train import generalize

torch.set_num_threads(1)
N = 513


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_primitives_match_jax_given_the_draws(seed):
    key = jax.random.PRNGKey(seed)
    ku, kv = jax.random.split(key)
    u, v = jax.random.uniform(ku, (N,)), jax.random.uniform(kv, (N,))
    _close(pds.sphere(_t(u), _t(v)), jds._sphere(key, N))

    ku, kv, kr = jax.random.split(key, 3)
    r = jax.random.uniform(kr, (), minval=0.12, maxval=0.42)
    _close(pds.torus(_t(jax.random.uniform(ku, (N,))),
                     _t(jax.random.uniform(kv, (N,))), _t(r)),
           jds._torus(key, N))

    ku, kv, kh, ks, kc = jax.random.split(key, 5)
    draws = (jax.random.uniform(ku, (N,)), jax.random.uniform(kv, (N,)),
             jax.random.uniform(kh, (), minval=0.5, maxval=1.3),
             jax.random.randint(ks, (N,), 0, 2) * 2 - 1,
             jax.random.uniform(kc, (N,)))
    _close(pds.cylinder(*map(_t, draws)), jds._cylinder(key, N))

    kh, kf, kp = jax.random.split(key, 3)
    half = jax.random.uniform(kh, (3,), minval=0.5, maxval=1.0)
    probs = jnp.repeat(jnp.stack([half[1] * half[2], half[0] * half[2],
                                  half[0] * half[1]]) /
                       (half[1] * half[2] + half[0] * half[2] +
                        half[0] * half[1]) / 2.0, 2)
    _close(pds.box_face_probs(_t(half)), probs)
    face = jax.random.categorical(kf, jnp.log(probs), shape=(N,))
    p = jax.random.uniform(kp, (N, 3)) * 2 - 1
    _close(pds.box(_t(half), _t(face).long(), _t(p)), jds._box(key, N))

    for label, prim in enumerate(jds._PRIMS):
        kp, ka, kq = jax.random.split(key, 3)
        aspect = jax.random.uniform(ka, (3,), minval=0.55, maxval=1.0)
        gauss = jax.random.normal(kq, (3, 3))
        got = pds.pose(_t(prim(kp, N)), _t(aspect), _t(gauss))
        _close(got, jds._primitive(key, label, N))


def test_householder_q_is_lapacks():
    rng = np.random.RandomState(0)
    for _ in range(20):
        a = rng.randn(3, 3).astype(np.float32)
        q_ref = np.asarray(jnp.linalg.qr(jnp.asarray(a))[0])
        q = pds.householder_q(_t(a)).numpy()
        np.testing.assert_allclose(q, q_ref, rtol=0, atol=2e-6)
        np.testing.assert_allclose(pds.det3(_t(q)).item(),
                                   np.linalg.det(q), atol=1e-5)


@pytest.mark.parametrize("b,n,res,cap", [
    (3, 400, 16, 2048),   # padded
    (3, 400, 16, 300),    # overflow: the largest keys drop
    (2, 1000, 8, 512),    # dense duplicates
])
def test_pack_voxels_matches_jax(b, n, res, cap):
    rng = np.random.RandomState(b * n + cap)
    vox = rng.randint(0, res, (b, n, 3)).astype(np.int32)
    got = pds.pack_voxels(_t(vox), res, cap)
    ref = jds.pack_voxels(jnp.asarray(vox), res, cap)
    for g, r in zip(got, ref):
        assert str(g.dtype).split(".")[-1] == str(np.asarray(r).dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(ValueError):
        pds.pack_voxels(torch.zeros((2, 1, 3), dtype=torch.int32), 1024, 8)


def test_procedural_batch_layout_and_distribution():
    b, n, res = 16, 2048, 32
    cap = b * n
    gen = torch.Generator().manual_seed(0)
    cpad, valid, feats, labels = pds.procedural_batch(gen, b, n, res, cap)
    assert cpad.shape == (cap, 4) and cpad.dtype == torch.int32
    assert valid.shape == (cap,) and valid.dtype == torch.bool
    assert feats.shape == (cap, 1) and feats.dtype == torch.float32
    assert labels.tolist() == [i % 4 for i in range(b)]
    c, v = cpad.numpy(), valid.numpy()
    assert (c[v, 1:] >= 0).all() and (c[v, 1:] < res).all()
    assert (c[~v] == 0).all() and (feats.numpy()[:, 0] == v).all()
    # canonical: unique and sorted by the batch-major flat key
    key = ((c[v, 0] * res + c[v, 1]) * res + c[v, 2]) * res + c[v, 3]
    assert (np.diff(key) > 0).all()
    again = pds.procedural_batch(torch.Generator().manual_seed(0), b, n,
                                 res, cap)
    assert torch.equal(again[0], cpad)
    jc, jv, _, jl = jds.procedural_batch(jax.random.PRNGKey(0), b, n, res,
                                         cap)
    assert np.asarray(jl).tolist() == labels.tolist()

    def per_class(coords, ok):
        cnt = np.bincount(coords[ok][:, 0], minlength=b)
        return np.array([cnt[k::4].mean() for k in range(4)])
    got, ref = per_class(c, v), per_class(np.asarray(jc), np.asarray(jv))
    assert (np.abs(got / ref - 1) < 0.15).all(), (got, ref)
    labelled = pds.procedural_batch(gen, 2, 64, res, 256, labels=[3, 1])
    assert labelled[3].tolist() == [3, 1]


def test_stream_device_step_runs(tmp_path, capsys):
    out = generalize.main([
        "--device", "cpu", "--stream_device", "--resolution", "32",
        "--points", "512", "--input_capacity", "1024", "--train_shapes",
        "4", "--val_shapes", "2", "--batch_size", "2", "--vae_channel", "4",
        "8", "8", "8", "4", "--steps_vae", "1", "--steps_diff", "0",
        "--ckpt_dir", str(tmp_path / "ckpt")])
    assert out["stream"] and out["stream_device"] and out["steps_vae"] == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
