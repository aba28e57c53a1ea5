"""The port's mesh data path against the JAX package, exactly.

The OFF, OBJ and GLB readers (the packed "OFF<nv> <nf> 0" header, n-gons,
negative and ``v/vt/vn`` indices, a strided GLB accessor), the face
sampling, the point budget, the rotation augmentation, and the datasets
(`ModelNet40Dataset` with its cache, augmentation, ``small_dataset`` and
captions; `ShapeNetDataset` over OBJ; `ObjaverseDataset` over GLB) draw
the same numbers in the same order as JAX's from the same seeds, and
give the same arrays bit for bit.  Each training entry point's first
collated ``--data`` batch equals JAX's collate of JAX's dataset, read in
the JAX example's order; ``train.vae`` takes one tiny ``--data`` step.
The meshes are small tori written by ``data.mesh_files`` (no download).
"""

import os

import numpy as np
import pytest
import torch

from mink_octtree_stablediffusion_tpu import data as jdata
from mink_octtree_stablediffusion_tpu.data import datasets as jds
from mink_octtree_stablediffusion_tpu.data import mesh as jmesh
from mink_octtree_stablediffusion_tpu_torch import data as pdata
from mink_octtree_stablediffusion_tpu_torch.data import mesh as pmesh
from mink_octtree_stablediffusion_tpu_torch.data import mesh_files
from mink_octtree_stablediffusion_tpu_torch.train import classification
from mink_octtree_stablediffusion_tpu_torch.train import diffusion
from mink_octtree_stablediffusion_tpu_torch.train import vae as train_vae
from mink_octtree_stablediffusion_tpu_torch.train import vqvae

torch.set_num_threads(1)
RES = 32


def _equal_samples(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A ModelNet40-layout tree (3 classes × 5 train + 2 test tori) and an
    OBJ twin with a ShapeNet-style repeated file name."""
    root = str(tmp_path_factory.mktemp("modelnet"))
    mesh_files.write_modelnet_tree(root, ("bowl", "cup", "lamp"), 5, 2,
                                   nu=12, nv=8, seed=3)
    obj_root = str(tmp_path_factory.mktemp("shapenet"))
    for c in ("chair", "table"):
        d = os.path.join(obj_root, c, "train")
        os.makedirs(d)
        v, f = mesh_files.torus_mesh(10, 6, small=0.3 if c == "chair" else .5)
        mesh_files.write_obj(os.path.join(d, "model.obj"), v, f)
    return root, obj_root


def test_off_obj_glb_readers_match_jax(tmp_path):
    v, f = mesh_files.torus_mesh(9, 5, scale=(1.0, 0.7, 1.3))
    for packed in (False, True):
        p = str(tmp_path / f"m{packed}.off")
        mesh_files.write_off(p, v, f, packed_header=packed)
        for a, b in zip(pdata.load_off(p), jds.load_off(p)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pdata.load_off(p)[0], v)
    p = str(tmp_path / "m.obj")
    with open(p, "w") as fh:
        fh.write("# comment\n\nv 0 0 0\nv 1 0 0\nv 1\t1 0\nv 0 1 0\n"
                 "vt 0 0\nf 1/1/1 2/2/2 3/3/3 4//4\nv 0 0 2\nf -1 -2 -3\n")
    for a, b in zip(pdata.load_obj(p), jds.load_obj(p)):
        np.testing.assert_array_equal(a, b)
    assert pdata.load_obj(p)[1].tolist() == [[0, 1, 2], [0, 2, 3],
                                             [4, 3, 2]]
    for stride in (None, 16, 20):
        p = str(tmp_path / f"m{stride}.glb")
        mesh_files.write_glb(p, v[:-1], f[f.max(1) < len(v) - 1],
                             stride=stride)
        for a, b in zip(pdata.load_glb(p), jmesh.load_glb(p)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pdata.load_glb(p)[0],
                                      v[:-1].astype(np.float32))
    with open(tmp_path / "bad.glb", "wb") as fh:
        fh.write(b"\0" * 12)
    with pytest.raises(ValueError):
        pdata.load_glb(str(tmp_path / "bad.glb"))


def test_sampling_and_rotation_match_jax():
    v, f = mesh_files.torus_mesh(11, 7, scale=(2.0, 1.0, 0.5))
    np.testing.assert_array_equal(pmesh.face_areas(v, f),
                                  jmesh.face_areas(v, f))
    for fn, args in ((pmesh.resample_mesh, (3.0,)),
                     (pmesh.resample_mesh_count, (777,))):
        jfn = getattr(jmesh, fn.__name__)
        a = fn(v, f, *args, rng=np.random.RandomState(5))
        b = jfn(v, f, *args, rng=np.random.RandomState(5))
        np.testing.assert_array_equal(a, b)
    xyz = pmesh.resample_mesh_count(v, f, 300, np.random.RandomState(1))
    for axis in ("all", "z"):
        pr, jr = np.random.RandomState(9), np.random.RandomState(9)
        np.testing.assert_array_equal(
            pdata.rotate_point_cloud(xyz, pr, axis),
            jdata.rotate_point_cloud(xyz, jr, axis))
        assert pr.rand() == jr.rand()  # the same draws were taken
    for res in (16, 32, 128, 256):
        assert pdata.point_budget(res) == jdata.point_budget(res)
    np.testing.assert_array_equal(pdata.normalize_to_resolution(xyz, 40),
                                  jdata.normalize_to_resolution(xyz, 40))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(augment=True, with_class=True, seed=4),
    dict(small_dataset=True, augment=True, cache=True),
])
def test_modelnet40_dataset_matches_jax(tree, tmp_path, kw):
    root, _ = tree
    kw = dict(kw)
    caches = {}
    if kw.pop("cache", False):
        caches = dict(port=str(tmp_path / "pc"), jax=str(tmp_path / "jc"))
    pds = pdata.ModelNet40Dataset(root, "train", RES,
                                  cache_dir=caches.get("port"), **kw)
    jd = jdata.ModelNet40Dataset(root, "train", RES,
                                 cache_dir=caches.get("jax"), **kw)
    assert pds.files == jd.files and pds.labels == jd.labels
    assert len(pds) == 15
    # an order with repeats (and the cache's second reads)
    for i in (0, 3, 7, 3, 14, 0, 9, 5, 5, 12):
        _equal_samples(pds[i], jd[i])
    if caches:
        assert sorted(os.listdir(caches["port"])) == \
            sorted(os.listdir(caches["jax"]))
        # the port reads a cache the JAX package wrote
        p2 = pdata.ModelNet40Dataset(root, "train", RES,
                                     cache_dir=caches["jax"], **kw)
        j2 = jdata.ModelNet40Dataset(root, "train", RES,
                                     cache_dir=caches["jax"], **kw)
        for i in (2, 1, 2, 6):
            _equal_samples(p2[i], j2[i])
    test_split = pdata.ModelNet40Dataset(root, "test", RES)
    assert test_split.files == jdata.ModelNet40Dataset(root, "test",
                                                       RES).files
    assert len(test_split) == 6


def test_shapenet_and_objaverse_match_jax(tree, tmp_path):
    _, obj_root = tree
    pds = pdata.ShapeNetDataset(obj_root, resolution=RES,
                                cache_dir=str(tmp_path / "p"), with_class=True)
    jd = jdata.ShapeNetDataset(obj_root, resolution=RES,
                               cache_dir=str(tmp_path / "j"), with_class=True)
    for i in (0, 1, 1, 0):
        _equal_samples(pds[i], jd[i])
    # the two model.obj files keep two cache entries
    assert len(os.listdir(tmp_path / "p")) == 2
    glb_root = tmp_path / "objaverse" / "sub"
    glb_root.mkdir(parents=True)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for k, uid in enumerate(("b_uid", "a_uid")):
        v, f = mesh_files.torus_mesh(8 + k, 6)
        mesh_files.write_glb(str(glb_root / f"{uid}.glb"), v, f,
                             stride=16 if k else None)
    np.save(img_dir / "a_uid.npy", np.arange(12.0).reshape(3, 4))
    kw = dict(resolution=RES, image_dir=str(img_dir), seed=2)
    po = pdata.ObjaverseDataset(str(tmp_path / "objaverse"),
                                cache_dir=str(tmp_path / "po"), **kw)
    jo = jdata.ObjaverseDataset(str(tmp_path / "objaverse"),
                                cache_dir=str(tmp_path / "jo"), **kw)
    assert po.files == jo.files and len(po) == 2
    for i in (1, 0, 1):
        _equal_samples(po[i], jo[i])
    assert "image_cond" in po[0] and "image_cond" not in po[1]


def _jax_first_batch(ds, warm, batch_size, seed):
    """JAX example order: the initial reads, then the first batch of
    `batch_iterator` under ``RandomState(seed)``."""
    [ds[i] for i in warm]
    return next(jdata.batch_iterator(ds, batch_size,
                                     np.random.RandomState(seed)))


class _FirstBatch(Exception):
    pass


def _capture(monkeypatch, module, name, stop=True):
    """Record the outputs of ``module.name``; raise after the first call
    when ``stop``."""
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(fn(*a, **k))
        if stop:
            raise _FirstBatch
        return calls[-1]
    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_train_vae_data_step_matches_jax(tree, tmp_path, monkeypatch):
    """One tiny ``--data`` step (augment, cache): its batch is JAX's."""
    root, _ = tree
    b, cap = 2, 4096
    calls = _capture(monkeypatch, train_vae, "collate_pointclouds",
                     stop=False)
    cache = str(tmp_path / "cache")
    assert train_vae.main([
        "--device", "cpu", "--data", root, "--cache_dir", cache,
        "--resolution", str(RES), "--input_capacity", str(cap),
        "--vae_channel", "4", "8", "8", "8", "4", "--batch_size", str(b),
        "--steps", "1", "--ckpt_dir", str(tmp_path / "ckpt")]) == 0
    assert len(calls) == 1 and os.listdir(cache)
    jd = jdata.ModelNet40Dataset(root, "train", RES, augment=True,
                                 cache_dir=str(tmp_path / "jcache"))
    samples = _jax_first_batch(jd, [0] + list(range(b)), b, 42)
    ref = jdata.collate_pointclouds([s["coords"] for s in samples], cap,
                                    200_000)
    for a, r in zip(calls[0], ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(r))


@pytest.mark.parametrize("entry", ["diffusion", "vqvae", "classification"])
def test_entry_point_first_data_batch_matches_jax(tree, tmp_path,
                                                  monkeypatch, entry):
    root, _ = tree
    b = 2
    if entry == "classification":
        npts = 256
        calls = _capture(monkeypatch, classification, "collate_fields")
        argv = ["--device", "cpu", "--data", root, "--resolution", str(RES),
                "--num_points", str(npts), "--batch_size", str(b),
                "--network", "pointnet", "--steps", "1"]
        with pytest.raises(_FirstBatch):
            classification.main(argv)
        samples = _jax_first_batch(
            jdata.ModelNet40Dataset(root, "train", RES), range(b), b, 42)
        unit = [(s["xyz"][:npts] / RES * 2.0 - 1.0).astype(np.float32)
                for s in samples]
        ref = jdata.collate_fields([(u + 1.0) / 0.05 for u in unit], unit,
                                   b * npts)
    else:
        module = {"diffusion": diffusion, "vqvae": vqvae}[entry]
        calls = _capture(monkeypatch, module, "collate_pointclouds")
        argv = ["--device", "cpu", "--data", root, "--resolution", str(RES),
                "--input_capacity", "4096", "--vae_channel", "4", "8", "8",
                "8", "4", "--batch_size", str(b), "--steps", "1",
                "--ckpt_dir", str(tmp_path / "ckpt")]
        if entry == "diffusion":
            argv += ["--unet_channel", "4", "8", "8", "8", "--group", "4"]
        else:
            argv += ["--num_embeddings", "8"]
        with pytest.raises(_FirstBatch):
            module.main(argv)
        samples = _jax_first_batch(
            jdata.ModelNet40Dataset(root, "train", RES), range(b), b, 42)
        ref = jdata.collate_pointclouds([s["coords"] for s in samples],
                                        4096, 200_000)
    for a, r in zip(calls[0], ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(r))
