"""A run's whole path on the CPU at tiny sizes (the look for a card
skipped): the contract's result line, and ``correct`` false under each
fault a cell can have, planted in the program underneath the run."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, run
from benchmark.tests import tiny

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
# limits at this size, on the CPU, where the program computes in float32;
# the free-running chain reads 0.5–3 % (an instance holds one or two cells
# at the UNet's coarse levels, where its norm magnifies rounding), and
# its generated cells, grown through four levels of near-zero random
# logits, 0–78 % apart
SEG = {"loss1_gap": 1e-3, "grad1_gap": 1e-2, "change_gap": 0.2}
TRAIN = dict(SEG, lost_cells=0, choice_gap=1e-3)
GEN = {"chain_gap": 0.1, "set_gap": tiny.LOOSE, "latent_gap": 1e-4,
       "eps_gap": 0.05, "logit_gap": 1e-4, "step_gap": 1e-4,
       "set_mismatch": 0}
LIMITS = {"vae": TRAIN, "seg": SEG, "gen": GEN}


def _run(kind, mix=None, **limits):
    spec = tiny.spec(kind, **limits)
    spec["mix"].update(mix or {})
    return run.run_cell(tiny.BENCH, spec, 2 ** 34 + 3, 0.5, False, CPU, 0.0)


@pytest.mark.parametrize("kind", ["vae", "seg", "gen"])
def test_result_line_has_the_contract_keys(kind):
    out = _run(kind, **LIMITS[kind])
    assert [k for k in out if k != "notes"] == KEYS
    assert list(out)[-1] == "checks" and out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"] for m in run.selected(tiny.BENCH["end_to_end"],
                                            f"tiny.{kind}")}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 or k == "peak_mem_gib"
               for k, v in out["metrics"].items())
    assert set(out["checks"]) == set(LIMITS[kind])
    json.dumps(out)


@pytest.mark.parametrize("kind,want", [
    ("vae", {"host_enqueue_ms.train", "mfu.train"}),
    ("gen", {"denoise_step_ms.gen", "encode_decode_ms.gen", "mfu.gen"})])
def test_traced_window_reads_its_layers(kind, want):
    """A traced run's window and readers; the readers of the profiled
    slice find nothing to read without a card and leave their metric
    out."""
    out = run.run_cell(tiny.BENCH, tiny.spec(kind, **LIMITS[kind]), 77, 0.5,
                       True, CPU, 0.0)
    assert set(out["metrics"]) == want
    assert all(0 < v["value"] < float("inf")
               for v in out["metrics"].values())


def _state_unchanged(monkeypatch, mp):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch, mp):
    """The program's input keeps only the first half of the instances."""
    from mink_octtree_stablediffusion_tpu_torch import serve
    from mink_octtree_stablediffusion_tpu_torch.train import segmentation
    from mink_octtree_stablediffusion_tpu_torch.train import vae

    def halved(fn, valid_at):
        def wrapped(*a, **kw):
            a = list(a)
            coords = a[0]
            n = int(coords[:, 0][a[valid_at] if valid_at < len(a) else
                                 kw["valid"]].max()) + 1
            keep = coords[:, 0] < (n + 1) // 2
            if valid_at < len(a):
                a[valid_at] = a[valid_at] & keep
            else:
                kw["valid"] = kw["valid"] & keep
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(vae, "sparse_tensor", halved(vae.sparse_tensor, 9))
    monkeypatch.setattr(serve, "sparse_tensor",
                        halved(serve.sparse_tensor, 9))
    monkeypatch.setattr(segmentation, "make_grid",
                        halved(segmentation.make_grid, 1))


def _answer_altered(monkeypatch, mp):
    """One voxel of every generated set moved where the program makes it."""
    from mink_octtree_stablediffusion_tpu_torch import serve
    forward = serve.GenerationProgram.forward

    def altered(self, *a, **kw):
        coords, valid = forward(self, *a, **kw)
        coords = coords.clone()
        coords[0, 1:] += 1
        return coords, valid
    monkeypatch.setattr(serve.GenerationProgram, "forward", altered)


FAULTS = [("vae", _state_unchanged), ("vae", _half_batch),
          ("seg", _state_unchanged), ("seg", _half_batch),
          ("gen", _half_batch), ("gen", _answer_altered)]


@pytest.mark.parametrize("kind,fault", FAULTS,
                         ids=[f"{k}-{f.__name__[1:]}" for k, f in FAULTS])
def test_a_planted_fault_makes_correct_false(monkeypatch, kind, fault):
    import mink_octtree_stablediffusion_tpu_torch as mp
    fault(monkeypatch, mp)
    out = _run(kind, **LIMITS[kind])
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("kind,mix", [
    ("vae", {"latent_rows": 8}), ("seg", {"capacity": 1800})],
    ids=["vae-decoder-buffers", "seg-level-buffers"])
def test_buffers_that_drop_cells_make_correct_false(kind, mix):
    """Buffers too small for the traffic: the VAE decoder's level buffers
    (8× a latent of 8 rows, under the 13–32 cells these batches have),
    MinkUNet's ``input_capacity // 8^i`` at one row a voxel (the coarse
    levels of a surface shrink about 4× a stride, not 8×)."""
    out = _run(kind, mix, **LIMITS[kind])
    assert out["correct"] is False, out["checks"]


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         "octree-ldm.vae-train-200k", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 2 and p.stdout.strip() == ""


def _copy(tmp_path):
    """BENCHMARK.json and the benchmark's folder alone, in ``tmp_path``."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def _in_copy(root, code: str, with_program: bool):
    path = [str(root)] + ([harness.ROOT] if with_program else [])
    prog = (f"import sys; sys.path[:0] = {path!r}\n"
            "import torch\nfrom benchmark import harness, run\n" + code)
    return subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, timeout=600, cwd=root)


def test_no_result_without_the_program(tmp_path):
    root = _copy(tmp_path)
    p = _in_copy(root, "spec = harness.cell_spec(harness.benchmark_file(), "
                 "'octree-ldm.vae-train-200k')\n"
                 "print(run.run_cell({}, spec, 1, 1, False, "
                 "torch.device('cpu'), 0))", with_program=False)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "mink_octtree_stablediffusion_tpu_torch" in p.stderr


def test_a_cell_is_new_files_and_one_entry(tmp_path):
    """A throwaway cell: a configuration file, a traffic mix, its limits
    and a per-layer metric's reader, all new files, one ``workloads``
    entry and the cell's name in the lists of the metrics it reports;
    no file under ``benchmark/`` that was there is edited."""
    root = _copy(tmp_path)
    bench_dir = root / "benchmark"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    cfg = dict(tiny.VAE["config"], name="tiny-vae")
    (bench_dir / "configs" / "tiny-vae.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "tiny-shapes.json").write_text(
        json.dumps(tiny.VAE["mix"]))
    (bench_dir / "limits" / "tiny-vae.shapes.json").write_text(
        json.dumps(TRAIN))
    (bench_dir / "metrics" / "points_a_step.train.py").write_text(
        "def read(ctx):\n    return ctx['train_points_per_s'] * "
        "ctx['window_s'] / ctx['attempted']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-vae", "source": "a test",
                             "file": "benchmark/configs/tiny-vae.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-vae.shapes",
                               "config": "tiny-vae",
                               "traffic": "tiny-shapes", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "octree-ldm.vae-train-200k" in m.get("workloads", []):
            m["workloads"].append("tiny-vae.shapes")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    p = _in_copy(root, "import json\n"
                 "b = harness.benchmark_file()\n"
                 "spec = harness.cell_spec(b, 'tiny-vae.shapes')\n"
                 "out = run.run_cell(b, spec, 5, 0.5, False, "
                 "torch.device('cpu'), 0)\n"
                 "ctx = {'train_points_per_s': 10.0, 'window_s': 2.0, "
                 "'attempted': 4}\n"
                 "out['extra'] = harness.metric_reader("
                 "'points_a_step.train')(ctx)\n"
                 "print(json.dumps(out))", with_program=True)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["extra"] == 5.0
    assert {"train_points_per_s", "setup_s"} <= set(out["metrics"])
    for path, data in before.items():
        assert path.read_bytes() == data, path
