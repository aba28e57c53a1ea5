"""API walk-through: the counterpart of `examples/api_demo.py`.

    python -m mink_octtree_stablediffusion_tpu_torch.api_demo
    python -m mink_octtree_stablediffusion_tpu_torch.api_demo --device cpu

The same steps on the same points (numpy seed 0) as the example: a
SparseTensor from 200 quantized points (bounded, extent 16³) and its
capacity report; a k3 conv, a k2-s2 strided conv into 64 rows and a
generative transpose into 512; pruning by the sign of the first channel;
global average pooling and its broadcast back; a TensorField voxelized
with no extent (an unbounded grid) and sliced back to its points; the
dense round trip.  It prints the example's lines.  The convs' weights are
random, from ``--seed`` (or given to ``main``): every count but the
pruned one is the example's whatever the weights.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from . import nn as mnn
from .ops import (batched_coordinates_np, pad_to_capacity, prune,
                  sparse_quantize_np)
from .tensor import (SparseTensor, TensorField, slice_to_field, sparse_tensor,
                     to_sparse_dense)
from .utils.device import make_generator, resolve_device
from .utils.summary import capacity_report


def build_convs(device, seed: int = 0) -> Dict[str, torch.nn.Module]:
    """The demo's three convs, initialised from ``seed``."""
    convs = {"conv": mnn.SparseConv(1, 8, kernel_size=3, device=device),
             "down": mnn.SparseConv(8, 8, kernel_size=2, stride=2,
                                    out_capacity=64, device=device),
             "up": mnn.GenerativeConvTranspose(8, 4, out_capacity=512,
                                               device=device)}
    gen = make_generator(seed, device)
    for m in convs.values():
        m.reset_parameters(generator=gen)
    return convs


def main(argv=None, convs: Optional[Dict[str, torch.nn.Module]] = None
         ) -> Dict[str, int]:
    """Run the walk-through; returns the printed voxel counts.  ``convs``
    replaces ``build_convs``' modules (same names and shapes)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the convs' random weights")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    convs = convs or build_convs(dev, args.seed)
    rng = np.random.RandomState(0)
    counts = {}

    def t(a):
        return torch.as_tensor(a, device=dev)

    with torch.no_grad():
        # -- SparseTensor construction -------------------------------
        pts = rng.rand(200, 3) * 16
        coords = batched_coordinates_np([sparse_quantize_np(pts, 1.0)])
        cpad, valid = pad_to_capacity(coords, 256)
        feats = t(valid.astype(np.float32))[:, None]
        st = sparse_tensor(t(cpad), feats, capacity=256, valid=t(valid),
                           extent=(16,) * 3)
        counts["input"] = int(st.count())
        print(f"voxelized {len(pts)} points -> {counts['input']} voxels")
        print(capacity_report(st, names=["input"]))

        # -- convolution ---------------------------------------------
        out = convs["conv"](st)
        print("conv k3:", tuple(out.F.shape), "stride", out.tensor_stride)
        mid = convs["down"](out)
        counts["strided"] = int(mid.count())
        print("strided conv:", counts["strided"], "voxels at stride",
              mid.tensor_stride)
        grown = convs["up"](mid)
        counts["grown"] = int(grown.count())
        print("generative transpose grew to", counts["grown"], "voxels")

        # -- pruning -------------------------------------------------
        grid, f = prune(grown.grid, grown.features, grown.features[:, 0] > 0)
        pruned = SparseTensor(grid=grid, features=f)
        counts["pruned"] = int(pruned.count())
        print("pruned to", counts["pruned"], "voxels")

        # -- global pool + broadcast ---------------------------------
        g = mnn.global_pool_features(out, "avg")
        back = mnn.broadcast_op(out, g, "add")
        print("global avg pool:", tuple(g.shape), "broadcast back:",
              tuple(back.F.shape))

        # -- TensorField voxelize / slice (no extent: unbounded) -----
        field = TensorField(
            t(np.concatenate([np.zeros((200, 1), np.float32),
                              pts.astype(np.float32)], 1)),
            t(rng.randn(200, 4).astype(np.float32)),
            torch.ones(200, dtype=torch.bool, device=dev))
        stf, inverse = field.sparse(capacity=256)
        sliced = slice_to_field(stf, field, inverse)
        counts["field"] = int(stf.count())
        print("field -> sparse:", counts["field"], "voxels; slice back:",
              tuple(sliced.F.shape))

        # -- dense round trip ----------------------------------------
        dense = st.dense((16, 16, 16))
        st2 = to_sparse_dense(dense, capacity=256)
        counts["dense"] = int(st2.count())
        print("dense:", tuple(dense.shape), "-> sparse:", counts["dense"],
              "voxels")
    print("API demo OK")
    return counts


if __name__ == "__main__":
    main()
