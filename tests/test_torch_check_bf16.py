"""The port's `train.check_bf16_training` against `scripts/check_bf16_training.py`.

- ``shell_cloud`` / ``make_batch`` (`train/vae_step_common.py`) equal the
  script's `scripts/bench_vae_step_common.py` bit for bit from the same
  ``RandomState(0)``.
- The entry point at ``--small --steps 3 --device cpu``: both curves, the
  final BCE line, finite losses, and an exit code that follows the verdict
  (3 steps cannot satisfy "final < 0.7 x first").
- The first float32 step's BCE at ``--small`` against the script's ``run``
  (1 step) from the same JAX init (carried across by ``utils.convert``) and
  the same reparameterisation noise, within 1e-4 relative (float32,
  summation order only).
"""

import importlib.util
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mink_octtree_stablediffusion_tpu as mt
from mink_octtree_stablediffusion_tpu import models as mm
from mink_octtree_stablediffusion_tpu import train as mtr
from mink_octtree_stablediffusion_tpu_torch.train import check_bf16_training
from mink_octtree_stablediffusion_tpu_torch.train import vae_step_common
from mink_octtree_stablediffusion_tpu_torch.utils.convert import load_flax

torch.set_num_threads(1)
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _script(name):
    """A module of `scripts/` by file (it imports its neighbours)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_batch_matches_script_bit_for_bit():
    ref = _script("bench_vae_step_common")
    for n, res in ((300, 16), (2000, 64)):
        np.testing.assert_array_equal(
            vae_step_common.shell_cloud(np.random.RandomState(0), n, res),
            ref.shell_cloud(np.random.RandomState(0), n, res))
    cs, vs = vae_step_common.make_batch(np.random.RandomState(0), 4, 2, 1024,
                                        16, 300)
    jcs, jvs = ref.make_batch(np.random.RandomState(0), 4, 2, 1024, 16, 300)
    assert cs.dtype == np.int32 and vs.dtype == bool
    np.testing.assert_array_equal(cs, np.asarray(jcs))
    np.testing.assert_array_equal(vs, np.asarray(jvs))


def test_entry_point_small_cpu(capsys):
    rc = check_bf16_training.main(["--small", "--steps", "3", "--device",
                                   "cpu"])
    out = capsys.readouterr()
    lines = out.out.splitlines()
    curves = {}
    for name in ("fp32", "bf16"):
        line = next(ln for ln in lines if ln.startswith(name + ": "))
        curves[name] = [tuple(float(v) for v in item.split(":"))
                        for item in line[len(name) + 2:].split()]
        assert [int(i) for i, _ in curves[name]] == [0, 1, 2]
        assert all(math.isfinite(v) and v > 0 for _, v in curves[name])
    final = next(ln for ln in lines if ln.startswith("final BCE "))
    assert f"fp32={curves['fp32'][-1][1]:.4f}" in final
    failures = check_bf16_training.verdict(curves, 0.15)[3]
    assert rc == (1 if failures else 0)
    assert ("BF16 TRAINING OK" in out.out) == (not failures)


def test_first_fp32_step_matches_script_run():
    script = _script("check_bf16_training")
    cfg = check_bf16_training.config(small=True)
    b, res, cap = cfg["b"], cfg["res"], cfg["cap"]
    cs, vs = vae_step_common.make_batch(np.random.RandomState(0), 4, b, cap,
                                        res, cfg["pts"])
    kw = {k: cfg[k] for k in ("channels", "encoder_capacities",
                              "decoder_capacities")}
    vae = mm.VAE(**kw)
    st0 = jax.jit(lambda c, v: mt.sparse_tensor(
        c, jnp.ones((cap, 1)), capacity=cap, batch_size=b, valid=v,
        extent=(res,) * 3))(jnp.asarray(cs[0]), jnp.asarray(vs[0]))
    variables = jax.jit(vae.init)(jax.random.PRNGKey(0), st0, st0.grid,
                                  jax.random.PRNGKey(0))
    curve = script.run(jnp.float32, vae, mtr.vae_optimizer(1e-3), variables,
                       jnp.asarray(cs), jnp.asarray(vs), cap, b, res, 1, 1)
    mt.ops.set_default_compute_dtype(None)

    env = check_bf16_training.setup(small=True, device="cpu")
    load_flax(env["vae"], variables)
    # the script's step-0 noise: PRNGKey(1) split once per step, the VAE
    # splitting that again (`models/vae.py:160-162`)
    sub = jax.random.split(jax.random.PRNGKey(1))[1]
    eps = jax.random.normal(jax.random.split(sub)[0],
                            (cfg["encoder_capacities"][2],
                             cfg["channels"][4]))
    out = check_bf16_training.run_arm(
        env, torch.float32, 1, 1, eps=lambda i: torch.as_tensor(
            np.array(eps)))
    assert "fused" in {r.branch for r in out["routes"]}
    np.testing.assert_allclose(out["curve"][0][1], curve[0][1], rtol=1e-4)
