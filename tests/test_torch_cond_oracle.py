"""``train.cond``'s classifier oracle and its per-class scoring
(`scripts/cond_control.py:164-280,403-511`), on the CPU.

The script's helpers are closures inside its ``main``; the references here
are their lines, written out: ``cls_collate`` (subsample, centre, unit
sphere, quantise), the confusion matrix, ``confusion_correct`` and the
Wilson interval, each held equal (exactly, or to float64 rounding).  The
oracle's optimizer against ``optax.chain(clip_by_global_norm(1.0),
adam(warmup_cosine(lr, 20, steps)))``.  Then ``train.cond`` end to end at
its smallest (2 classifier steps, 4 held-out shapes, 2 diffusion steps,
one CFG scale, one round of 2 DDPM steps) with ``--device cpu``: the
script's JSON keys, and each sweep cell consistent with its parts.
"""

import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mink_octtree_stablediffusion_tpu import train as jtrain
from mink_octtree_stablediffusion_tpu.data import collate as jcollate
from mink_octtree_stablediffusion_tpu_torch.train import cond

torch.set_num_threads(1)


def _script_cls_collate(coords_list, cls_points, rng, cap):
    pts = []
    for c in coords_list:
        c = np.asarray(c, np.float32)
        idx = rng.randint(0, len(c), cls_points)
        x = c[idx]
        center = 0.5 * (x.max(0) + x.min(0))
        x = x - center
        x = x / max(np.linalg.norm(x, axis=1).max(), 1e-6)  # unit sphere
        pts.append(x)
    unit = pts
    coords = [(u + 1.0) / 0.05 for u in unit]
    return jcollate.collate_fields(coords, unit, cap)


def test_cls_collate_matches_script(rng):
    clouds = [rng.randint(0, 32, (n, 3)) for n in (40, 7, 1)]
    got = cond.cls_collate(clouds, cls_points=16,
                           rng=np.random.RandomState(3), capacity=48)
    ref = _script_cls_collate(clouds, 16, np.random.RandomState(3), 48)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert got[0][:, 1:].max() < cond.CLS_EXTENT[0]


def test_confusion_and_scoring_match_script(rng):
    n = 4
    trues = rng.randint(0, n, 60).tolist()
    preds = [t if rng.rand() < 0.6 else int(rng.randint(-1, n))
             for t in trues]
    confusion = np.zeros((n, n))
    for p, t in zip(preds, trues):
        if p >= 0:
            confusion[t, p] += 1
    conf_norm = confusion / np.maximum(confusion.sum(1, keepdims=True), 1.0)
    np.testing.assert_array_equal(cond.confusion_matrix(preds, trues, n),
                                  conf_norm)
    gen = [2] * 5 + [1] * 3 + [-1, 0]
    cell = cond.score_class(gen, 2, conf_norm)
    hist = np.bincount([p for p in gen if p >= 0], minlength=n).astype(float)
    q = hist / max(hist.sum(), 1.0)
    p, *_ = np.linalg.lstsq(conf_norm.T, q, rcond=None)
    p = np.clip(p, 0.0, None)
    p = p / max(p.sum(), 1e-9)
    acc, m, z = 0.5, len(gen), 1.96
    center = (acc + z * z / (2 * m)) / (1 + z * z / m)
    half = (z / (1 + z * z / m)) * float(
        np.sqrt(acc * (1 - acc) / m + z * z / (4 * m * m)))
    assert cell["acc"] == acc and cell["empty"] == 1
    np.testing.assert_array_equal(cell["hist"], hist)
    assert cell["corrected"] == float(p[2])
    assert cell["ci"] == max(acc - (center - half), (center + half) - acc)
    for a in (0.0, 1.0):  # the normal approximation's degenerate cells
        assert cond.wilson_halfwidth(a, 12) > 0.1


def test_oracle_optimizer_matches_optax(rng):
    lr, steps = 1e-3, 50
    p0 = rng.randn(6, 2).astype(np.float32)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(jtrain.warmup_cosine(lr, 20, steps)))
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    param = torch.nn.Parameter(torch.as_tensor(p0))
    opt = cond.canvas_vae_optimizer([param], lr, steps)
    for s in (0.3, 5.0, 0.1, 2.0):  # unclipped and clipped gradients
        g = rng.randn(6, 2).astype(np.float32) * s
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        param.grad = torch.as_tensor(g)
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-7)


TINY = ["--device", "cpu", "--resolution", "32", "--points", "400",
        "--input_capacity", "1024", "--batch_size", "2", "--vae_channel",
        "4", "8", "8", "8", "4", "--unet_channel", "4", "8", "8", "8",
        "--group", "4", "--cross_attention_dim", "16", "--train_shapes",
        "4", "--val_shapes", "2", "--steps_diff", "2", "--steps_cls", "2",
        "--cls_points", "64", "--oracle_shapes", "4", "--cfg_scales", "3",
        "--rounds", "1", "--sample_steps", "2"]


def test_cond_oracle_entry_point(tmp_path, capsys):
    out = cond.main(TINY + ["--ckpt_dir", str(tmp_path / "ck")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        out
    for key in ("classifier_val_acc", "classifier_val_per_class",
                "oracle_confusion", "oracle_shapes", "cfg_sweep",
                "best_scale", "best_mean_conditional_acc", "stream"):
        assert key in out, key
    assert out["oracle_shapes"] == 4 and out["stream"] is False
    conf = np.array(out["oracle_confusion"])
    assert conf.shape == (4, 4)
    assert np.all((conf.sum(1) == 0) | np.isclose(conf.sum(1), 1.0))
    assert out["best_scale"] == "3.0"
    cell = out["cfg_sweep"]["3.0"]
    assert cell["samples_per_class"] == 2
    assert set(cell["per_class"]) == {"sphere", "torus", "box", "cylinder"}
    assert cell["mean"] == pytest.approx(np.mean(list(
        cell["per_class"].values())))
    assert out["best_mean_conditional_acc"] == cell["mean"]
    assert out["steps_diff"] == 2 and np.isfinite(out["diff_loss_last"])
