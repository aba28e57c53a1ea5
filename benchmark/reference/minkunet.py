"""MinkUNet34C's segmentation loss in plain PyTorch (Choy et al., CVPR
2019; MinkowskiEngine ``examples/minkunet.py``).

Stem: k5 conv, batch norm, ReLU.  Four encoder stages, each a k2-s2 conv
onto every cell of the coarsened grid (MinkowskiEngine keeps them all),
batch norm, ReLU, then residual blocks (k3 conv, batch norm, ReLU, k3 conv, batch norm, the
skip added, ReLU; where the width changes the skip is a 1×1 conv and
batch norm).  Four decoder stages, each a k2-s2 transpose conv onto the
matching encoder grid, batch norm, ReLU, the encoder features
concatenated, then residual blocks; a 1×1 head with bias.  Loss: the mean
cross-entropy over the labelled cells.

Parameters are read by the names of the segmentation network's
``state_dict``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from . import sparse as sp


def _bn(P, name, f):
    return sp.batch_norm(f, P[name + ".weight"], P[name + ".bias"])


def block(P: Dict[str, torch.Tensor], name: str, grid: sp.Grid,
          f: torch.Tensor) -> torch.Tensor:
    o = F.relu(_bn(P, name + ".norm1", sp.conv_same(
        f, P[name + ".conv1.kernel"], grid)))
    o = _bn(P, name + ".norm2", sp.conv_same(o, P[name + ".conv2.kernel"],
                                            grid))
    if name + ".downsample_conv.kernel" in P:
        f = _bn(P, name + ".downsample_norm", sp.product(
            f, P[name + ".downsample_conv.kernel"][0]))
    return F.relu(o + f)


def forward(P, grid: sp.Grid, feats: torch.Tensor,
            layers: Sequence[int]) -> torch.Tensor:
    """Per-cell logits on ``grid``'s rows."""
    def stage(i, g, f):
        for j in range(layers[i - 1]):
            f = block(P, f"block{i}_{j}", g, f)
        return f

    def down(i, g, f):
        h, g = sp.conv_down(f, P[f"conv{i}_conv.kernel"], g)
        return g, F.relu(_bn(P, f"conv{i}_bn", h))

    out_p1 = F.relu(_bn(P, "bn0", sp.conv_same(feats, P["conv0.kernel"],
                                                grid)))
    g1, f = down(1, grid, out_p1)
    out_b1 = stage(1, g1, f)
    g2, f = down(2, g1, out_b1)
    out_b2 = stage(2, g2, f)
    g3, f = down(3, g2, out_b2)
    out_b3 = stage(3, g3, f)
    g4, f = down(4, g3, out_b3)
    f = stage(4, g4, f)
    g = g4
    for i, (sg, sf) in zip((4, 5, 6, 7), ((g3, out_b3), (g2, out_b2),
                                          (g1, out_b1), (grid, out_p1))):
        h = sp.conv_up(f, P[f"convtr{i}_conv.kernel"], g, sg)
        h = F.relu(_bn(P, f"convtr{i}_bn", h))
        g, f = sg, stage(i + 1, sg, torch.cat([h, sf], 1))
    return f @ P["final.kernel"][0] + P["final.bias"]


def loss(P, coords: torch.Tensor, feats: torch.Tensor, labels: torch.Tensor,
         *, extent: int, batch: int, layers: Sequence[int]):
    """``coords`` [N, 4] distinct voxels, ``feats`` [N, C], ``labels`` [N]
    → (mean cross-entropy over the labelled voxels, {"acc"})."""
    grid = sp.make_grid(coords, 1, extent, batch)
    order = torch.argsort(sp.cell_keys(coords.long(), 1, extent))
    f, lab = feats[order], labels[order].long()
    logits = forward(P, grid, f, layers)
    m = lab >= 0
    ce = F.cross_entropy(logits[m], lab[m])
    acc = (logits[m].argmax(-1) == lab[m]).float().mean()
    return ce, {"acc": acc}
