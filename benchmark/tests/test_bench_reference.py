"""The plain reference agrees with the program at a tiny size on the CPU
(float32 on both sides), and imports nothing of the program."""

import ast
import glob
import os

import pytest
import torch

from benchmark import harness
from benchmark.reference import sparse as sp
from benchmark.tests import tiny

CPU = torch.device("cpu")


def _gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(harness.HERE, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert not n.startswith("mink_octtree"), (path, n)


@pytest.mark.parametrize("kind", ["vae", "seg"])
def test_training_loss_and_gradients_match(kind):
    """The program's loss and every parameter's gradient on one batch
    against the reference's, from the same drawn weights."""
    spec = tiny.spec(kind)
    cell = harness.entry_module(spec["mix"]["entry"]).Cell(spec, 4, CPU)
    module, state, step, cell.weights, feed, _ = cell.build()
    args, kw = feed[0]
    module.train()
    loss_p, _ = cell.loss_fn(module, *args, **kw)
    grads_p = torch.autograd.grad(loss_p, list(module.parameters()))
    P = {k: v.clone().requires_grad_(True)
         for k, v in cell.weights_for_reference().items()}
    loss_r, _ = cell.reference_loss(P, 0)
    grads_r = torch.autograd.grad(loss_r, [P[n] for n, _ in
                                           module.named_parameters()])
    lp, lr = float(loss_p.detach()), float(loss_r.detach())
    assert abs(lp - lr) <= 1e-5 * abs(lr)
    for (n, _), gp, gr in zip(module.named_parameters(), grads_p, grads_r):
        assert _gap(gp, gr) <= 1e-4, n


def test_generation_follows_the_program():
    """The tiny generation cell's encoder latent and decoder logits agree
    to float32 rounding, the DDIM steps exactly, every set the program
    made; the UNet's noise prediction within 1e-2: at this size an
    instance holds one or two cells at the coarse levels, where the
    instance norm magnifies the float32 rounding of its means (the program
    pools them in float32 even in a float64 run, and the two sides then
    differ by 2.6e-3)."""
    from benchmark import run
    out = run.run_cell(tiny.BENCH, tiny.spec("gen"), 98765432101, 0.1,
                       False, CPU, 0.0)
    c = {k: v["value"] for k, v in out["checks"].items()}
    assert c["latent_gap"] < 1e-5 and c["logit_gap"] < 1e-5
    assert c["step_gap"] < 1e-5 and c["set_mismatch"] == 0
    assert c["eps_gap"] < 1e-2


def test_precision_control_is_further_out():
    """The control's int8 products (and float8 ones) move the tiny VAE's
    gradients more than bf16 ones do, and bf16 more than float32."""
    spec = tiny.spec("vae")
    cell = harness.entry_module("train_vae").Cell(spec, 9, CPU)
    cell.setup()
    cell.release()
    ref = cell.reference()
    gaps = {p: {c["name"]: c["value"] for c in cell.compare(
        cell.reference(p), ref)} for p in ("bfloat16", "float8", "int8")}
    assert gaps["int8"]["grad1_gap"] > 3 * gaps["bfloat16"]["grad1_gap"]
    assert gaps["float8"]["grad1_gap"] > 3 * gaps["bfloat16"]["grad1_gap"]
    assert gaps["bfloat16"]["grad1_gap"] > 1e-4
    assert sp.get_precision() == "float32"
