"""Host feeding: the prefetching loader and the native voxelizer.

``PrefetchLoader`` on the CPU: batches in order as tensors (tuples,
dicts, NamedTuples), an error in the source re-raised at ``next()``, and
``close()`` / ``with`` unblocking a worker stuck on a full queue.  (Its
CUDA path, pinned copies on a side stream, is driven by ``chip_smoke.py``'s
data phase on the card.)

``native``: the port's C++ library, built at first use with the host's
compiler, equals the JAX package's library (built from the JAX package's
own ``voxelize.cpp`` into a temporary directory, so that the comparison
does not depend on whether that package's library was built) and the
port's plain paths (numpy; a Python loop for the label consensus), bit
for bit; without a compiler the functions take the plain paths; a
compiler that fails raises with its output.  The JAX package's numpy
fallback of ``quantize_label`` orders its labels differently from its own
C++ (the C++ defines the consensus), so the port's plain version is the
loop.
"""

import shutil
import subprocess
import threading
import time
from typing import NamedTuple

import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu.native as jnative
from mink_octtree_stablediffusion_tpu_torch import native
from mink_octtree_stablediffusion_tpu_torch.data import PrefetchLoader
from mink_octtree_stablediffusion_tpu_torch.native import build as nbuild
from mink_octtree_stablediffusion_tpu_torch.ops.coords import INVALID_COORD
from mink_octtree_stablediffusion_tpu_torch.ops.morton import morton_encode_np

torch.set_num_threads(1)


class Pair(NamedTuple):
    a: np.ndarray
    b: np.ndarray


def test_prefetch_yields_batches_in_order():
    src = [(np.full((3,), i, np.int32), {"x": np.ones((2, 2)) * i},
            Pair(np.arange(i + 1), np.zeros(1)))
           for i in range(7)]
    with PrefetchLoader(iter(src), prefetch=2, device="cpu") as loader:
        got = list(loader)
    assert len(got) == 7
    for i, (t, d, p) in enumerate(got):
        assert isinstance(t, torch.Tensor) and t.tolist() == [i] * 3
        assert torch.equal(d["x"], torch.ones(2, 2, dtype=torch.float64) * i)
        assert isinstance(p, Pair) and p.a.tolist() == list(range(i + 1))
    with pytest.raises(ValueError):
        PrefetchLoader([], prefetch=0)


def test_prefetch_reraises_source_errors():
    def src():
        yield (np.zeros(2),)
        raise KeyError("boom")
    loader = PrefetchLoader(src(), device="cpu")
    assert next(loader)[0].tolist() == [0.0, 0.0]
    with pytest.raises(KeyError, match="boom"):
        next(loader)


def test_prefetch_close_unblocks_a_full_queue():
    made = []

    def src():
        for i in range(1000):
            made.append(i)
            yield (np.full(4, i),)
    loader = PrefetchLoader(src(), prefetch=1, device="cpu")
    assert next(loader)[0][0].item() == 0
    time.sleep(0.3)  # the worker fills the queue and blocks
    n = len(made)
    assert n < 10
    t = threading.Thread(target=loader.close)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and not loader._thread.is_alive()
    assert len(made) <= n + 1


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's library, built from its own source."""
    out = tmp_path_factory.mktemp("jaxnative") / "libvoxelize.so"
    cxx = nbuild.compiler()
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    subprocess.check_call([cxx, "-O3", "-shared", "-fPIC",
                           jnative.__file__.replace("__init__.py",
                                                    "voxelize.cpp"),
                           "-o", str(out)])
    return str(out)


@pytest.fixture
def jax_native(jax_lib, monkeypatch):
    monkeypatch.setattr(jnative, "_LIB_PATH", jax_lib)
    monkeypatch.setattr(jnative, "_lib", None)
    assert jnative.available()
    return jnative


@pytest.fixture
def plain_native(monkeypatch):
    """The port's native module on its plain paths (no library)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    return native


def _clouds(rng, sizes=(3000, 1, 1500), scale=20.0):
    pts = [(rng.rand(n, 3) * scale - scale / 4).astype(np.float32)
           for n in sizes]
    pts[0][100:200] = pts[0][:100]  # exact repeats
    return pts


def test_native_matches_jax_and_the_plain_paths(jax_native, plain_native,
                                                rng):
    assert native._load() is None  # the plain fixture is active
    clouds = _clouds(rng)
    coords = np.concatenate([np.floor(c).astype(np.int32) for c in clouds])
    labels = rng.randint(0, 4, len(coords)).astype(np.int32)
    plain = {
        "sq": native.sparse_quantize(clouds[0], 1.0, return_inverse=True),
        "sq_half": native.sparse_quantize(clouds[0], 0.5),
        "ql": native.quantize_label(coords, labels, -100),
        "mc": native.morton_codes(coords, 2),
        "cb": native.collate_batch(clouds, 1.0, 4000, INVALID_COORD),
        "cb_cut": native.collate_batch(clouds, 0.5, 900, -1)}
    native._tried = False
    assert native.available()
    got = {
        "sq": native.sparse_quantize(clouds[0], 1.0, return_inverse=True),
        "sq_half": native.sparse_quantize(clouds[0], 0.5),
        "ql": native.quantize_label(coords, labels, -100),
        "mc": native.morton_codes(coords, 2),
        "cb": native.collate_batch(clouds, 1.0, 4000, INVALID_COORD),
        "cb_cut": native.collate_batch(clouds, 0.5, 900, -1)}
    ref = {
        "sq": jax_native.sparse_quantize(clouds[0], 1.0,
                                         return_inverse=True),
        "sq_half": jax_native.sparse_quantize(clouds[0], 0.5),
        "ql": jax_native.quantize_label(coords, labels, -100),
        "mc": jax_native.morton_codes(coords, 2),
        "cb": jax_native.collate_batch(clouds, 1.0, 4000, INVALID_COORD),
        "cb_cut": jax_native.collate_batch(clouds, 0.5, 900, -1)}
    def parts(x):
        return x if isinstance(x, tuple) else (x,)
    for k in ref:
        assert len(parts(got[k])) == len(parts(ref[k]))
        for g, p, r in zip(parts(got[k]), parts(plain[k]), parts(ref[k])):
            np.testing.assert_array_equal(g, r, err_msg=k)
            np.testing.assert_array_equal(p, r, err_msg=k)
    assert (got["ql"][1] == -100).any() and (got["ql"][1] >= 0).any()
    assert got["cb_cut"][1].all()  # 900 rows overflow: truncated


def test_quantize_label_plain_is_the_consensus():
    c = np.array([[0, 0], [1, 1], [0, 0], [2, 2], [1, 1], [0, 0]], np.int32)
    lab = np.array([5, 7, 5, 1, 8, 9], np.int32)
    uc, ul, inv = native.quantize_label_plain(c, lab, -1)
    assert uc.tolist() == [[0, 0], [1, 1], [2, 2]]
    assert ul.tolist() == [-1, -1, 1] and inv.tolist() == [0, 1, 0, 2, 1, 0]
    with pytest.raises(ValueError):
        native.quantize_label(c, lab[:3])


def test_native_build_without_and_with_a_failing_compiler(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nbuild, "compiler", lambda: None)
    assert nbuild.build() is None
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available()
    x = np.array([[1, 2, 3], [-4, 5, 600]], np.int32)
    np.testing.assert_array_equal(native.morton_codes(x, 2),
                                  morton_encode_np(x, 2))
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on this host")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nbuild, "SOURCE", bad)
    monkeypatch.setattr(nbuild, "compiler", lambda: cxx)
    with pytest.raises(RuntimeError, match="not C"):
        nbuild.build()
