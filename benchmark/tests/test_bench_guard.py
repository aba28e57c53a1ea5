"""The import guard: no file of the benchmark imports JAX or the JAX
package, and the check of ``sys.modules`` compares top-level names whole
(the port's name begins with the JAX package's)."""

import glob
import os

import pytest

from benchmark import harness

FILES = sorted(glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                         recursive=True))


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, harness.HERE) for p in FILES])
def test_no_file_imports_jax_or_the_jax_package(path):
    assert harness.forbidden_imports(path) == []


def test_forbidden_names_compare_whole(tmp_path):
    assert harness.forbidden_loaded(
        ["mink_octtree_stablediffusion_tpu_torch.ops.fused_conv",
         "jaxtyping", "flaxen", "numpy"]) == []
    assert harness.forbidden_loaded(
        ["mink_octtree_stablediffusion_tpu.ops", "jaxlib.xla_client",
         "jax", "optax._src", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "mink_octtree_stablediffusion_tpu",
        "optax"]
    src = tmp_path / "x.py"
    src.write_text("import mink_octtree_stablediffusion_tpu_torch as a\n"
                   "from mink_octtree_stablediffusion_tpu.ops import b\n"
                   "import jax.numpy\n")
    assert harness.forbidden_imports(str(src)) == [
        "jax.numpy", "mink_octtree_stablediffusion_tpu.ops"]


def test_a_cpu_run_loads_no_jax():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch\n"
            "from benchmark import harness, run\n"
            "from benchmark.tests import tiny\n"
            "run.run_cell(tiny.BENCH, tiny.spec('vae'), 1, 0.2, False, "
            "torch.device('cpu'), 0)\n"
            "print(harness.forbidden_loaded())\n" % harness.ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
