"""On the card: one short run of every cell through ``run.py``, each
ending in a correct result line.  Skips where there is no card.

    python -m pytest benchmark/tests/test_bench_card.py -q
"""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.benchmark_file()["workloads"]])
def test_a_short_run_is_correct(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused conv kernels have no "
                    "interpreted mode")
    p = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         workload, "--seed", "20260101", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
