"""The octree VAE's training loss, and its eval-mode encoder and
pruning decoder, in plain PyTorch.

Encoder: three ResNet stages, each a stride-2 k3 conv head onto every
cell of the coarsened grid, batch norm and ELU, then one residual block
(k3 conv, batch norm, ELU, k3 conv, batch norm, the skip added, ELU); two
more stages at the latent stride 8 with a k3 head; the mean and
log-variance k3 heads.  Reparameterisation ``z = mean + exp(log_var / 2)
· eps``.  Decoder: one stage at stride 8 with a k3 head, then three
stages whose head is the generative k2-s2 transpose conv onto the octree
children of every kept cell; after each stage a 1×1 occupancy head with
bias, the membership of each cell in the input set coarsened to the
stage's stride, and the cells kept: a positive logit, or (levels 0–2,
training) a target cell.  No set has a buffer: every cell is kept at
every stride, as the published network keeps it.  Generation may cap the
kept cells at ``max_keep`` a level (the configuration's top-k clamp: a
logit above the ``max_keep``-th largest).  Loss: the per-level mean
BCE-with-logits over the stage's cells, averaged over the four levels,
plus ``kld_weight`` times the KL divergence summed over the latent
channels and averaged over its cells.

Parameters are read by the names of the octree VAE's ``state_dict``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import sparse as sp


def _bn(P, name, f, training=True):
    if training:
        return sp.batch_norm(f, P[name + ".weight"], P[name + ".bias"])
    return (f - P[name + ".running_mean"]) * torch.rsqrt(
        P[name + ".running_var"] + 1e-5) * P[name + ".weight"] + P[
        name + ".bias"]


def stack(P: Dict[str, torch.Tensor], name: str, grid: sp.Grid,
          f: torch.Tensor, head: str, training: bool = True):
    """One ResNet stage of two layers → (grid, features); batch norm on
    the batch's statistics in training, else on the running ones."""
    w = P[name + ".head.conv.kernel"]
    if head == "down":
        h, grid = sp.conv_down(f, w, grid)
    elif head == "up":
        out = sp.children(grid)
        h, grid = sp.conv_up(f, w, grid, out), out
    else:
        h = sp.conv_same(f, w, grid)
    t = training
    h = F.elu(_bn(P, name + ".head.norm.bn", h, t))
    b = name + ".block1"
    o = F.elu(_bn(P, b + ".norm1.bn", sp.conv_same(
        h, P[b + ".conv1.kernel"], grid), t))
    o = _bn(P, b + ".norm2.bn", sp.conv_same(o, P[b + ".conv2.kernel"],
                                              grid), t)
    return grid, F.elu(o + h)


def top_k_keep(logits: torch.Tensor, k: Optional[int]) -> torch.Tensor:
    """A positive logit; where ``k`` is given and more than ``k`` are
    positive, a logit above the ``k``-th largest."""
    keep = logits > 0
    if k is not None and int(keep.sum()) > k:
        kth = torch.sort(logits, descending=True).values[
            min(k, len(logits)) - 1]
        keep = logits > kth.clamp(min=0.0)
    return keep


def encode(P, grid: sp.Grid, training: bool = True):
    """→ (latent grid, mean, log_var)."""
    f = torch.ones((len(grid), 1), device=grid.coords.device)
    for i in range(3):
        grid, f = stack(P, f"encoder.block{i + 1}", grid, f, "down",
                        training)
    for i in (4, 5):
        grid, f = stack(P, f"encoder.block{i}", grid, f, "same",
                        training=training)
    mean = sp.conv_same(f, P["encoder.mean_conv.kernel"], grid)
    log_var = sp.conv_same(f, P["encoder.log_var_conv.kernel"], grid)
    return grid, mean, log_var


def decode(P, grid: sp.Grid, z: torch.Tensor, target: sp.Grid,
           max_keep: Optional[int], training: bool, follow=None):
    """→ (per-level logits, per-level targets, the cells kept at stride
    1, the followed masks).  With ``follow`` (training: the coordinates
    [M, 4] another decoder kept at levels 0–2), those cells and the targets
    are kept in place of the ones the logits choose, and the followed
    masks are, per level 0–2, the followed cells among this decoder's
    candidates."""
    logits_l, targets_l, chosen_l = [], [], []
    f = z
    for lvl in range(4):
        grid, f = stack(P, f"decoder.block{lvl + 1}", grid, f,
                        "same" if lvl == 0 else "up", training)
        c = f"decoder.block{lvl + 1}_cls"
        logits = (f @ P[c + ".kernel"][0] + P[c + ".bias"])[:, 0]
        strided = sp.make_grid(target.coords, grid.stride, target.extent,
                               target.batch)
        tgt = sp.member(grid, strided)
        if follow is not None and lvl < 3:
            keep = sp.member(grid, sp.make_grid(follow[lvl], grid.stride,
                                                grid.extent, grid.batch))
            chosen_l.append(keep)
        else:
            keep = top_k_keep(logits.detach(), max_keep)
        if training and lvl < 3:
            keep = keep | tgt
        logits_l.append(logits)
        targets_l.append(tgt)
        grid = sp.Grid(grid.coords[keep], grid.stride, grid.extent,
                       grid.batch)
        f = f[keep]
    return logits_l, targets_l, grid, chosen_l


def loss(P, coords: torch.Tensor, eps: torch.Tensor, *, extent: int,
         batch: int, kld_weight: float, follow=None):
    """The training loss of one batch: ``coords`` [N, 4] the input voxels,
    ``eps`` [≥ latent cells, C] the reparameterisation noise, one row per
    latent cell in key order; ``follow`` as ``decode`` takes it → (loss,
    {"bce", "kld", "levels"}), ``levels`` per decoder level 0–2 the
    (logits, targets, followed cells) masks when ``follow`` is given."""
    grid = sp.make_grid(coords, 1, extent, batch)
    lat, mean, log_var = encode(P, grid)
    z = mean + torch.exp(0.5 * log_var) * eps[:len(lat)]
    logits, targets, _, chosen = decode(P, lat, z, grid, None,
                                        training=True, follow=follow)
    bce = sum(sp.bce_with_logits(lo, t) for lo, t in zip(logits, targets)
              ) / len(logits)
    kld = -0.5 * (1 + log_var - mean ** 2 - torch.exp(log_var)).sum() / max(
        len(lat), 1)
    levels = [(lg.detach(), t, c) for lg, t, c in zip(logits, targets,
                                                      chosen)]
    return bce + kld_weight * kld, {"bce": bce, "kld": kld,
                                    "levels": levels}


def rows_of(grid: sp.Grid, coords: torch.Tensor) -> tuple:
    """(rows of ``grid`` holding ``coords``, -1 where none; how many of
    ``coords`` and of ``grid`` the other lacks)."""
    idx = sp.lookup(grid, coords.long())
    found = int((idx >= 0).sum())
    return idx, (len(coords) - found) + (len(grid) - found)


def decode_following(P, grid: sp.Grid, z: torch.Tensor, levels,
                     max_keep: Optional[int]):
    """The eval-mode decoder followed on the program's own sets.

    ``levels``: for each of the four levels, the program's (candidate
    coordinates [N, 4] in key order, their logits [N], the kept
    coordinates [M, 4]).  At each level the reference grows the program's
    kept set of the level before (or takes the latent grid), computes its
    logits there, and goes on from the program's kept rows → (for each
    level the reference's logits on the program's candidates, 0 where it
    has no such cell; the number of cells where the program's sets differ
    from the reference's growth or from the choice its own logits make)."""
    out, mismatch = [], 0
    f = z
    for lvl, (cand, logits_p, kept) in enumerate(levels):
        grid, f = stack(P, f"decoder.block{lvl + 1}", grid, f,
                        "same" if lvl == 0 else "up", training=False)
        c = f"decoder.block{lvl + 1}_cls"
        logits = (f @ P[c + ".kernel"][0] + P[c + ".bias"])[:, 0]
        idx, miss = rows_of(grid, cand)
        mismatch += miss
        out.append(torch.where(idx >= 0, logits[idx.clamp(min=0)], 0.0))
        chosen = cand[top_k_keep(logits_p, max_keep)]
        _, miss = rows_of(sp.Grid(chosen.long(), grid.stride, grid.extent,
                                  grid.batch), kept)
        mismatch += miss
        rows, _ = rows_of(grid, kept)
        rows = rows[rows >= 0]
        grid = sp.Grid(grid.coords[rows], grid.stride, grid.extent,
                       grid.batch)
        f = f[rows]
    return out, mismatch
