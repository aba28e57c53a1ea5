"""How far float32 gradients of one MinkowskiSplatFCNN train step lie from
a float64 evaluation, in the JAX package and in the PyTorch port.

    JAX_PLATFORMS=cpu python tests/splat_step_vs_f64.py
    JAX_PLATFORMS=cpu python tests/splat_step_vs_f64.py --network minkfcnn

The step, weights and batch are those of
``tests/test_torch_classification.py::test_classifier_step_matches_jax``.
The float64 side is the port with its parameters and features in float64
and the coordinates kept in float32, so that every voxel and every
multilinear weight is the same function of the coordinates.  For each
gradient tensor it prints, as a share of that tensor's own max|float64|:
the port's float32 gradient against JAX's, JAX's against float64, and the
port's against float64; then the largest of each.  It shows how
ill-conditioned the step is in float32, which sets that test's tolerance.
Not a test: it repeats the test's step with an extra float64 pass.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import test_torch_classification as tcls  # noqa: E402
from mink_octtree_stablediffusion_tpu_torch.utils.convert import (  # noqa: E402
    from_flax)


def port_grads(pnet, batch, dtype):
    net = copy.deepcopy(pnet).to(dtype)
    net.train()
    cpad, valid, fpad, labels = batch
    field = tcls.tc.build_field(cpad, valid, fpad.astype(
        np.float64 if dtype == torch.float64 else np.float32),
        batch_size=tcls.B, extent=tcls.EXTENT, device="cpu")
    loss = F.cross_entropy(net(field), torch.as_tensor(labels).long())
    loss.backward()
    return loss.item(), {k: p.grad.double().numpy()
                         for k, p in net.named_parameters()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default="minksplatfcnn",
                    choices=["minkfcnn", "minksplatfcnn"])
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    batch = tcls._batch(first=2)
    jf, _ = tcls._fields(batch)
    labels = jnp.asarray(batch[3].astype(np.int32))
    jnet, pnet = tcls._classifier(args.network)
    variables = tcls._carry(jnet, pnet, np.random.RandomState(0), jf)

    def loss_fn(params, batch_stats):
        logits, _ = jnet.apply({"params": params,
                                "batch_stats": batch_stats}, jf,
                               mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()

    jloss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"], variables["batch_stats"])
    jax32 = {k: v.numpy().astype(np.float64)
             for k, v in from_flax({"params": grads}).items()}
    l32, port32 = port_grads(pnet, batch, torch.float32)
    l64, port64 = port_grads(pnet, batch, torch.float64)
    print(f"loss: jax float32 {float(jloss):.9f}, port float32 {l32:.9f}, "
          f"port float64 {l64:.9f}")
    rows = []
    for name, ref in port64.items():
        top = np.abs(ref).max()
        if top == 0.0:  # no gradient on any side: compared exactly
            assert not port32[name].any() and not jax32[name].any(), name
            continue
        rows.append((np.abs(port32[name] - jax32[name]).max() / top,
                     np.abs(jax32[name] - ref).max() / top,
                     np.abs(port32[name] - ref).max() / top, name))
    print("port32-jax32  jax32-f64  port32-f64  (of the tensor's max)")
    for row in sorted(rows, reverse=True):
        print("%.3e    %.3e  %.3e  %s" % row)
    print("max: %.3e    %.3e  %.3e" % tuple(max(r[i] for r in rows)
                                             for i in range(3)))


if __name__ == "__main__":
    main()
