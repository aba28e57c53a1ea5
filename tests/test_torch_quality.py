"""The quality and diagnosis entry points of the PyTorch port
(``train.e2e_quality``, ``train.vqvae_quality``, ``train.diag_eval_decode``,
``train.measure_occupancy``) against the repository's scripts and the JAX
package, on the CPU at small sizes.

- The metrics: ``voxel_sets`` / ``iou`` equal to `scripts/e2e_quality.py`'s
  exactly; the codebook perplexity and active-code fraction equal to
  `scripts/vqvae_quality.py`'s formula within 1e-12.
- ``measure_occupancy`` prints the script's lines, line for line.
- ``diag_eval_decode.level_table`` on the port VAE's eval-mode and
  train-mode outputs equals the table the script computes from JAX's
  ``vae.apply`` with the same weights and input: counts exactly, recall
  and precision within 1e-6.  The flax variables are filled from the
  port's weights (``jax.eval_shape``, no JAX ``init`` compile); the
  occupancy heads are scaled ×100 so that no keep decision lies near its
  threshold, and the test reports any logit within 1e-6 of 0.
- Each entry point at cut flags: its keys, finite values, IoUs in [0, 1].
"""

import contextlib
import importlib.util
import io
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mink_octtree_stablediffusion_tpu import models as mm
import mink_octtree_stablediffusion_tpu as mt
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.train import (diag_eval_decode,
                                                          e2e_quality,
                                                          measure_occupancy,
                                                          vqvae_quality)
from mink_octtree_stablediffusion_tpu_torch.utils import convert
from mink_octtree_stablediffusion_tpu_torch.utils.convert import load_flax

ROOT = Path(__file__).resolve().parent.parent
RES, B, CAP, VCH = 16, 2, 1024, (8, 16, 16, 16, 4)


def _script(name):
    """`scripts/<name>.py` imported as a module (it imports JAX)."""
    spec = importlib.util.spec_from_file_location(
        f"script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Grid:
    def __init__(self, coords, valid):
        self.coords, self.valid = coords, valid


class _St:
    def __init__(self, coords, valid):
        self.grid = _Grid(coords, valid)


def _random_sets(rng, n):
    c = np.concatenate([rng.randint(0, 3, (n, 1)),
                        rng.randint(0, 4, (n, 3))], 1).astype(np.int32)
    return c, rng.rand(n) < 0.7


def test_voxel_sets_and_iou_match_script():
    script = _script("e2e_quality")
    rng = np.random.RandomState(0)
    for _ in range(5):
        (ca, va), (cb, vb) = _random_sets(rng, 200), _random_sets(rng, 150)
        ja, jb = script.voxel_sets(_St(ca, va)), script.voxel_sets(_St(cb, vb))
        pa = e2e_quality.voxel_sets(_St(torch.as_tensor(ca),
                                        torch.as_tensor(va)))
        pb = e2e_quality.voxel_sets(_St(torch.as_tensor(cb),
                                        torch.as_tensor(vb)))
        assert pa == ja and pb == jb
        for x, y in ((ja, jb), (jb, ja), (ja, ja), ({}, jb)):
            assert e2e_quality.iou(x, y) == script.iou(x, y)


def test_codebook_stats_match_script_formula():
    rng = np.random.RandomState(1)
    for k, n in ((512, 3000), (64, 10), (16, 1)):
        codes = rng.randint(0, k // 2, n)
        # scripts/vqvae_quality.py :198-202
        hist = np.bincount(codes, minlength=k).astype(np.float64)
        pk = hist / max(hist.sum(), 1.0)
        nz = pk[pk > 0]
        perplexity = float(np.exp(-np.sum(nz * np.log(nz))))
        active = float(np.mean(hist > 0))
        got = vqvae_quality.codebook_stats(codes, k)
        assert abs(got[0] - perplexity) <= 1e-12 * perplexity
        assert abs(got[1] - active) <= 1e-12


@pytest.mark.parametrize("procedural", [False, True])
def test_measure_occupancy_prints_the_scripts_lines(monkeypatch, procedural):
    argv = ["--resolution", "32", "--points", "2000", "--samples", "2"] + (
        ["--procedural"] if procedural else [])
    script = _script("measure_occupancy")
    monkeypatch.setattr(sys, "argv", ["measure_occupancy.py"] + argv)
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        script.main()
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        out = measure_occupancy.main(argv)
    assert got.getvalue().splitlines() == want.getvalue().splitlines()
    assert len(out["decoder_capacities"]) == 4


def _flax_from_port(shapes, module):
    """The flax variables of ``shapes`` holding ``module``'s parameters
    and statistics, through `utils.convert`'s name map."""
    sd = {k: v.detach().numpy() for k, v in module.state_dict().items()}

    def leaf(path, x):
        keys = tuple(str(k.key) for k in path)
        name, _ = convert._translate(keys[0], keys[1:], np.zeros(x.shape))
        a = sd[name]
        return jnp.asarray(a.T if keys[-1] == "kernel" and a.ndim == 2
                           else a)
    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    load_flax(module, variables)  # the cover is one to one
    return variables


def _script_table(out_clss, targets):
    """`scripts/diag_eval_decode.py`'s per-level walk (:102-137)."""
    rows = []
    for lt, tg in zip(out_clss, targets):
        v = np.asarray(lt.valid)
        lo = np.asarray(lt.features[:, 0])
        t = np.asarray(tg) & v
        keep = (lo > 0) & v
        inter = keep & t
        rows.append({"capacity": lt.capacity, "candidates": int(v.sum()),
                     "saturated": bool(v.sum() >= lt.capacity),
                     "target": int(t.sum()), "keep": int(keep.sum()),
                     "recall": inter.sum() / max(t.sum(), 1),
                     "precision": inter.sum() / max(keep.sum(), 1)})
    return rows


def _near_zero(out_clss) -> int:
    return sum(int(((np.abs(np.asarray(lt.features[:, 0])) <= 1e-6) &
                    np.asarray(lt.valid)).sum()) for lt in out_clss)


def test_level_table_matches_jax():
    enc_caps, dec_caps = mp.serve.capacities(CAP)
    ds = mp.data.SyntheticShapes(resolution=RES, num_samples=B,
                                 points_per_shape=1500)
    cpad, valid, feats, _ = mp.data.collate_pointclouds(
        [ds[i]["coords"] for i in range(B)], CAP)
    pvae = mp.models.VAE(channels=VCH, encoder_capacities=enc_caps,
                         decoder_capacities=dec_caps, device="cpu", seed=3)
    with torch.no_grad():
        for name, p in pvae.named_parameters():
            if "_cls" in name and name.endswith("kernel"):
                p.mul_(100.0)
    jvae = mm.VAE(channels=VCH, encoder_capacities=enc_caps,
                  decoder_capacities=dec_caps)
    st = mt.sparse_tensor(jnp.asarray(cpad), jnp.asarray(feats),
                          capacity=CAP, batch_size=B,
                          valid=jnp.asarray(valid), extent=(RES,) * 3)
    k = jax.random.PRNGKey(4)
    variables = _flax_from_port(jax.eval_shape(jvae.init, k, st, st.grid, k),
                                pvae)
    eps = jax.random.normal(jax.random.split(k)[0], (enc_caps[2], VCH[4]))
    pst = mp.sparse_tensor(torch.as_tensor(cpad), torch.as_tensor(feats),
                           capacity=CAP, batch_size=B,
                           valid=torch.as_tensor(valid), extent=(RES,) * 3)
    for train in (False, True):
        if train:
            (jout, jtg, *_), _ = jax.jit(lambda v: jvae.apply(
                v, st, st.grid, k, train=True, mutable=["batch_stats"]))(
                variables)
        else:
            jout, jtg, *_ = jax.jit(lambda v: jvae.apply(
                v, st, st.grid, k, train=False))(variables)
        pvae.train(train)
        with torch.no_grad():
            pout, ptg, *_ = pvae(pst, pst.grid,
                                 eps=torch.as_tensor(np.array(eps)))
        got = diag_eval_decode.level_table(pout, ptg)
        want = _script_table(jout, jtg)
        near = _near_zero(jout)
        msg = f"train={train}: {near} JAX logits within 1e-6 of 0"
        assert len(got) == len(want) == 4, msg
        for g, w in zip(got, want):
            for key in ("capacity", "candidates", "saturated", "target",
                        "keep"):
                assert g[key] == w[key], (key, g, w, msg)
            for key in ("recall", "precision"):
                assert abs(g[key] - float(w[key])) <= 1e-6, (key, g, w, msg)
        assert any(0 < r["keep"] < r["candidates"] for r in got), got


def _finite(out: dict) -> bool:
    return all(math.isfinite(v) for v in out.values()
               if isinstance(v, float))


def test_e2e_quality_entry_point_runs():
    steps = []
    out = e2e_quality.main(
        ["--device", "cpu", "--resolution", "16", "--steps_vae", "3",
         "--steps_diff", "3", "--sample_steps", "2"],
        on_step=lambda phase, i, loss, aux: steps.append((phase, i)))
    assert set(out) == {"bce", "reconstruction_iou", "generation_iou"}
    assert _finite(out) and out["bce"] is not None
    assert 0 <= out["reconstruction_iou"] <= 1
    assert 0 <= out["generation_iou"] <= 1
    assert steps == [("vae", i) for i in (1, 2, 3)] + [
        ("diff", i) for i in (1, 2, 3)]


@pytest.mark.parametrize("flags", [[], ["--ema", "--restart_dead"],
                                   ["--stream"]])
def test_vqvae_quality_entry_point_runs(flags):
    out = vqvae_quality.main(["--device", "cpu", "--resolution", "16",
                              "--points", "512", "--input_capacity", "1024",
                              "--steps", "3"] + flags)
    assert set(out) == {"reconstruction_iou", "bce", "vq_loss",
                        "codebook_perplexity", "active_code_fraction",
                        "generalize"}
    assert _finite(out) and out["generalize"] == ("--stream" in flags)
    assert 0 <= out["reconstruction_iou"] <= 1
    assert 1 <= out["codebook_perplexity"] <= 512
    assert 0 < out["active_code_fraction"] <= 1


def test_diag_eval_decode_entry_point_runs():
    out = diag_eval_decode.main(
        ["--device", "cpu", "--resolution", "16", "--points", "2048",
         "--input_capacity", "4096", "--vae_channel", "8", "16", "16", "16",
         "4", "--steps_vae", "3"])
    assert 0 <= out["eval_iou"] <= 1 and 0 <= out["train_iou"] <= 1
    for table in (out["eval_table"], out["train_table"]):
        assert len(table) == 4
        for r in table:
            assert 0 <= r["recall"] <= 1 and 0 <= r["precision"] <= 1
            assert r["target"] <= r["candidates"] <= r["capacity"]
