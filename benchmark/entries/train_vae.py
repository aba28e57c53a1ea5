"""The octree VAE's training step (``train.make_train_step`` over
``train.vae.build_loss_fn`` on ``TrainState(VAE, vae_optimizer)``), fed
collated batches of the mix and one reparameterisation noise a batch.

The published network keeps every cell at every stride.  The program
holds each level in a buffer, so the cell sizes the buffers to hold
every cell its traffic can make (``capacities``), and the check counts
the cells the program lost in the set-up's steps (``lost_cells``, limit
0): at each decoder level, the program's candidates against the octree
children of every cell that its own logits and targets keep, and its
latent and target sets against the input's cells at their strides.

Which cells the decoder keeps beyond the targets is a choice by the sign
of a logit, and at random weights many logits lie near 0, so rounding
alone flips some of them.  The reference therefore follows the cells the
program kept at levels 0–2 (as a served model's tokens are followed), and
the first step's choices are judged by the reference's logit
(``choice_gap``: the largest reference logit on the wrong side of a
choice the program made, over the cells it was free to choose).  The
control chooses by its own logits."""

from __future__ import annotations

import torch

from .. import harness, traffic, work
from ..reference import sparse as sp
from ..reference import vae as ref_vae
from .training import REF_STEPS, TrainCell


def capacities(c: int, latent_rows: int) -> tuple:
    """(encoder, decoder) buffer rows a level for an input buffer of ``c``
    rows and at most ``latent_rows`` latent cells.  The encoder follows
    ``examples/train_vae.py`` (surfaces shrink about 4× a level).  Each
    decoder level holds the octree children of every cell of the level
    before (8× its rows), so that no cell the decoder keeps, forced or by
    its logits, is dropped: ``(enc[2], 8·L, 64·L, 512·L)``."""
    enc = tuple(max(c // d, 128) for d in (2, 4, 16)) + (max(c // 16, 128),) * 2
    dec = (enc[2],) + tuple(latent_rows * 8 ** i for i in (1, 2, 3))
    return enc, dec


STRIDES = (8, 4, 2, 1)  # of the decoder's levels


class Cell(TrainCell):

    def build(self):
        import mink_octtree_stablediffusion_tpu_torch as mp
        from mink_octtree_stablediffusion_tpu_torch.train import vae as tv

        dev, cfg, mix = self.device, self.config, self.mix
        if dev.type == "cuda":
            mp.utils.cuda_build.build()
        cap, res = mix["capacity"], mix["resolution"]
        self.batch_size = mix["per_batch"]
        self.enc_caps, self.dec_caps = capacities(cap, mix["latent_rows"])
        vae = mp.models.VAE(channels=tuple(cfg["vae_channels"]),
                            encoder_capacities=self.enc_caps,
                            decoder_capacities=self.dec_caps, device=dev,
                            seed=0)
        gen = harness.seeded(self.seed, dev)
        weights = harness.draw_weights(vae, gen)
        vae.load_state_dict(weights)
        vae.train()
        self.level_counts, self.kept = [], []
        dec = vae.decoder
        self._watch = [dec.register_forward_hook(self._count_levels),
                       dec.register_forward_pre_hook(
                           lambda mod, args: self.kept.append([]))]
        for lvl in range(2, 5):
            self._watch.append(getattr(dec, f"block{lvl}")
                               .register_forward_pre_hook(self._keep_kept))
        self._ref_levels = {}
        self.param_names = {n for n, _ in vae.named_parameters()}
        train = cfg["train"]
        state = mp.train.TrainState(vae, mp.train.vae_optimizer(
            vae.parameters(), train["lr"]))
        self.loss_fn = tv.build_loss_fn(
            input_capacity=cap, batch_size=self.batch_size, resolution=res,
            kld_weight=train["kld_weight"], device=dev)
        step = mp.train.make_train_step(harness.spanned("forward",
                                                        self.loss_fn))
        state.optimizer.step = harness.spanned("optimizer",
                                               state.optimizer.step)
        latent = (self.enc_caps[2], cfg["vae_channels"][-1])
        self.batches, feed, points = [], [], []
        for b in traffic.make_batches(mix, self.seed):
            coords, valid, feats, _ = traffic.collate(b, cap)
            t = tuple(torch.as_tensor(a, device=dev)
                      for a in (coords, valid, feats))
            eps = torch.randn(latent, generator=gen, device=dev)
            self.batches.append((t[0][t[1]], eps))
            feed.append(((t,), {"eps": eps}))
            points.append(int(valid.sum()))
        return vae, state, step, weights, feed, points

    def setup(self) -> None:
        super().setup()
        for h in self._watch:
            h.remove()

    def _keep_kept(self, mod, args):
        """A pre-hook on decoder levels 1–3: the cells the level before
        kept (the first steps', which the reference follows)."""
        if len(self.kept) <= REF_STEPS:
            g = args[0].grid
            self.kept[-1].append(g.coords[g.valid].long())

    def _count_levels(self, mod, args, out):
        """A forward hook on the decoder: per level, on the card, the
        candidates, the cells its logits and targets keep (the published
        rule, levels 0–2 forced) and the targets among the candidates."""
        logits, targets, _ = out
        rows = []
        for lvl, (lg, tg) in enumerate(zip(logits, targets)):
            v = lg.valid
            tg = tg & v
            keep = (lg.features[:, 0] > 0) & v
            if lvl < 3:
                keep = keep | tg
            rows.append(torch.stack([v.sum(), keep.sum(), tg.sum()]))
        self.level_counts.append(torch.stack(rows))

    def release(self) -> None:
        self.level_counts = [c.tolist() for c in self.level_counts]
        super().release()

    def lost_cells(self) -> int:
        """Cells the program dropped in the set-up's steps: each level's
        candidates against 8× the cells kept at the level before, the
        latent set and each level's targets against the input's cells at
        the level's stride."""
        res, lost = self.mix["resolution"], 0
        for i, counts in enumerate(self.level_counts):
            coords = self.batches[i % len(self.batches)][0]
            exact = [len(sp.make_grid(coords, s, res, self.batch_size))
                     for s in STRIDES]
            lost += abs(counts[0][0] - exact[0])
            for lvl in range(4):
                lost += abs(counts[lvl][2] - exact[lvl])
                if lvl < 3:
                    lost += abs(8 * counts[lvl][1] - counts[lvl + 1][0])
        return lost

    def prog_readings(self) -> dict:
        return {**super().prog_readings(), "lost_cells": self.lost_cells()}

    def reference_loss(self, P, i: int):
        coords, eps = self.batches[i]
        loss, aux = ref_vae.loss(P, coords, eps, follow=self.kept[i],
                                 **self._sizes())
        self._ref_levels[i] = aux["levels"]
        return loss, aux

    def reference(self, precision: str = "float32") -> dict:
        out = super().reference(precision)
        out["levels"] = [self._ref_levels[i] for i in range(REF_STEPS)]
        return out

    def more_readings(self, got: dict, ref: dict) -> dict:
        """``choice_gap``: of the program's choices (the followed cells),
        or a control's (its own logits' signs), on the first step, where
        both sides start from the same weights, the largest reference
        logit on the wrong side, over the cells that are not targets."""
        gap = 0.0
        for lvl, (r, tgt, chosen) in enumerate(ref["levels"][0]):
            if "levels" in got:
                chosen = got["levels"][0][lvl][0] > 0
            free = ~tgt
            wrong = torch.cat([-r[chosen & free], r[~chosen & free],
                               r.new_zeros(1)])
            gap = max(gap, float(wrong.max()))
        return {"choice_gap": gap}

    def _sizes(self) -> dict:
        return dict(extent=self.mix["resolution"], batch=self.batch_size,
                    kld_weight=self.config["train"]["kld_weight"])

    def flops(self, i: int) -> float:
        if not hasattr(self, "_flops"):
            self._flops = {}
        if i not in self._flops:
            s = self._sizes()
            self._flops[i] = work.vae_train_flops(
                self.batches[i][0], extent=s["extent"], batch=s["batch"],
                channels=self.config["vae_channels"])
        return self._flops[i]
