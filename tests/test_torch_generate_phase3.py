"""The port's renders, its `generate` entry point and phase 3 of
`scripts/e2e_generalize.py` (`train/generalize.py`), on the CPU.

- ``utils.viz.sparse_tensor_clouds`` equals JAX's on the same voxels;
  ``render_pointclouds`` writes a PNG.
- ``python -m ...generate`` at tiny widths writes ``generated.png``.
- ``generation_metrics`` on planted voxel sets (identical to a train
  shape, disjoint from every shape, half-overlapping, empty) equals a
  numpy reckoning written out as `scripts/e2e_generalize.py:447-480`
  computes it.
- A tiny ``train.generalize`` run with phase 3 returns JAX's result keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mink_octtree_stablediffusion_tpu as mt
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch import generate
from mink_octtree_stablediffusion_tpu_torch.train import generalize
from mink_octtree_stablediffusion_tpu_torch.utils import viz

# the keys of `scripts/e2e_generalize.py`'s result
JAX_RESULT_KEYS = {
    "val_recon_iou", "train_recon_iou", "gen_size_valid_frac",
    "gen_nearest_train_iou_mean", "gen_nearest_train_iou_max",
    "gen_nearest_val_iou_mean", "gen_voxels_median", "prediction_type",
    "stream", "stream_device", "resolution"}


def test_sparse_tensor_clouds_match_jax(rng):
    cap, b, res = 128, 3, 16
    coords = np.concatenate([np.concatenate(
        [np.full((30, 1), i), np.unique(rng.randint(0, res, (30, 3)),
                                        axis=0)[:30]], 1)
        for i in (0, 2)]).astype(np.int32)  # instance 1 left empty
    coords = np.unique(coords, axis=0)
    cpad, valid = mt.ops.pad_to_capacity(coords, cap)
    jst = jax.jit(lambda c, v: mt.sparse_tensor(
        c, jnp.zeros((cap, 1)), capacity=cap, batch_size=b, valid=v,
        extent=(res,) * 3))(jnp.asarray(cpad), jnp.asarray(valid))
    pst = mp.sparse_tensor(torch.as_tensor(cpad), torch.zeros(cap, 1),
                           capacity=cap, batch_size=b,
                           valid=torch.as_tensor(valid), extent=(res,) * 3)
    ref = mt.utils.sparse_tensor_clouds(jst, 4)
    for got in (viz.sparse_tensor_clouds(pst, 4),
                viz.sparse_tensor_clouds(pst.grid, 4)):
        assert len(got) == len(ref) == b
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    assert len(ref[1]) == 0


def test_render_pointclouds_writes_a_png(tmp_path, rng):
    path = viz.render_pointclouds(
        [rng.randint(0, 16, (50, 3)), np.zeros((0, 3))],
        str(tmp_path / "r" / "clouds.png"), titles=["a", "b"], resolution=16)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_generate_entry_point_writes_the_render(tmp_path):
    out = generate.main([
        "--device", "cpu", "--resolution", "16", "--input_capacity", "256",
        "--batch_size", "2", "--vae_channel", "8", "12", "16", "16", "4",
        "--unet_channel", "4", "8", "16", "16", "--group", "4",
        "--scheduler", "ddim", "--sample_steps", "1", "--out_dir",
        str(tmp_path / "samples")])
    assert (tmp_path / "samples" / "generated.png").stat().st_size > 0
    assert out["first_s"] > 0 and out["steady_s"] > 0
    assert int(out["sout"].valid.sum()) > 0


def _reckoning(gen_sets, train_coords, val_coords, res):
    """`scripts/e2e_generalize.py:447-480`, as written there."""
    def flat_keys(arr):
        c = np.asarray(arr, np.int64)
        return np.unique((c[:, 0] * res + c[:, 1]) * res + c[:, 2])

    def iou_keys(a, b):
        inter = len(np.intersect1d(a, b, assume_unique=True))
        u = len(a) + len(b) - inter
        return inter / u if u else 1.0

    counts = [len(s) for s in gen_sets]
    train_bank = [flat_keys(c) for c in train_coords]
    val_bank = [flat_keys(c) for c in val_coords]
    gen_keys = [flat_keys(np.array(sorted(g), np.int64).reshape(-1, 3))
                if g else np.empty((0,), np.int64) for g in gen_sets]
    tcounts = [len(s) for s in train_bank]
    lo_count = 0.3 * float(np.median(tcounts))
    nearest_train, nearest_val = [], []
    for g in gen_keys:
        nearest_train.append(max((iou_keys(g, t) for t in train_bank),
                                 default=0.0))
        nearest_val.append(max((iou_keys(g, t) for t in val_bank),
                               default=0.0))
    hi_count = 3.0 * float(np.median(tcounts))
    valid_frac = float(np.mean([lo_count <= c <= hi_count for c in counts]))
    hist, edges = np.histogram(nearest_train, bins=np.arange(0, 1.05, 0.1))
    return {"nearest_train": nearest_train, "nearest_val": nearest_val,
            "novelty_histogram": dict(zip([f"{e:.1f}" for e in edges[:-1]],
                                          hist.tolist())),
            "gen_size_valid_frac": valid_frac,
            "gen_nearest_train_iou_mean": float(np.mean(nearest_train)),
            "gen_nearest_train_iou_max": float(np.max(nearest_train)),
            "gen_nearest_val_iou_mean": float(np.mean(nearest_val)),
            "gen_voxels_median": int(np.median(counts))}


def test_phase3_metrics_match_the_reckoning(rng):
    res = 32
    train = [np.unique(rng.randint(0, 16, (n, 3)), axis=0)
             for n in (200, 300, 250)]
    val = [np.unique(rng.randint(8, 24, (220, 3)), axis=0)]
    half = {tuple(r) for r in train[1][: len(train[1]) // 2]} | {
        (x, y, 31) for x in range(10) for y in range(10)}
    gen_sets = [{tuple(r) for r in train[0]},  # a copy of a train shape
                {(30, 30, z) for z in range(20)},  # disjoint, too small
                half,  # half overlapping a train shape
                set()]  # empty
    got = generalize.generation_metrics(gen_sets, train, val, res)
    ref = _reckoning(gen_sets, train, val, res)
    for key, value in ref.items():
        assert got[key] == value, key
    assert got["counts"] == [len(s) for s in gen_sets]
    assert got["gen_nearest_train_iou_max"] == 1.0
    assert got["nearest_train"][1] == 0.0 and got["nearest_train"][3] == 0.0


def test_generalize_phase3_returns_jax_result_keys(tmp_path):
    out = generalize.main([
        "--device", "cpu", "--resolution", "32", "--points", "400",
        "--input_capacity", "1024", "--batch_size", "2",
        "--vae_channel", "4", "8", "8", "8", "4",
        "--unet_channel", "4", "8", "8", "8", "--group", "4",
        "--train_shapes", "4", "--val_shapes", "2", "--steps_vae", "1",
        "--steps_diff", "1", "--sample_steps", "2", "--gen_samples", "2",
        "--tag", "tiny", "--viz_dir", str(tmp_path / "viz"),
        "--ckpt_dir", str(tmp_path / "ck")])
    assert JAX_RESULT_KEYS <= set(out)
    assert 0.0 <= out["gen_size_valid_frac"] <= 1.0
    assert out["gen_nearest_train_iou_max"] <= 1.0
    assert (tmp_path / "viz" / "e2e_generalize_tiny.png").stat().st_size > 0
