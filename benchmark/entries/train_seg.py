"""MinkUNet34C's segmentation training step (``train.make_train_step``
over ``train.segmentation.build_loss_fn`` on ``TrainState(MinkUNet34C,
vae_optimizer)``, the Adam of the port's segmentation example), fed the
mix's collated rooms as the example feeds them: host arrays, which the
loss moves to the card, deduplicates and reduces."""

from __future__ import annotations

import torch

from .. import harness, traffic, work
from ..reference import minkunet as ref_mink
from .training import TrainCell


class Cell(TrainCell):

    def build(self):
        import mink_octtree_stablediffusion_tpu_torch as mp
        from mink_octtree_stablediffusion_tpu_torch.train import \
            segmentation as ts

        dev, cfg, mix = self.device, self.config, self.mix
        if dev.type == "cuda":
            mp.utils.cuda_build.build()
        cap, ext = mix["capacity"], mix["extent"]
        self.batch_size = mix["per_batch"]
        net = getattr(mp.models, cfg["model"])(
            out_channels=cfg["out_channels"], in_channels=cfg["in_channels"],
            init_dim=cfg["init_dim"], input_capacity=cap,
            planes=tuple(cfg["planes"]), device=dev, seed=0)
        if tuple(net.layers) != tuple(cfg["layers"]):
            raise ValueError(f"{cfg['model']} has layers {net.layers}")
        gen = harness.seeded(self.seed, dev)
        weights = harness.draw_weights(net, gen)
        net.load_state_dict(weights)
        net.train()
        self.param_names = {n for n, _ in net.named_parameters()}
        state = mp.train.TrainState(net, mp.train.vae_optimizer(
            net.parameters(), cfg["train"]["lr"]))
        self.loss_fn = ts.build_loss_fn(
            batch_size=self.batch_size, resolution=ext, device=dev)
        step = mp.train.make_train_step(harness.spanned("forward",
                                                        self.loss_fn))
        state.optimizer.step = harness.spanned("optimizer",
                                               state.optimizer.step)
        self.batches, feed, points = [], [], []
        for b in traffic.make_batches(mix, self.seed):
            coords, valid, feats, labels = traffic.collate(b, cap)
            feed.append((((coords, valid, feats, labels),), {}))
            points.append(int(valid.sum()))
            self.batches.append(tuple(
                torch.as_tensor(a[valid], device=dev)
                for a in (coords, feats, labels)))
        return net, state, step, weights, feed, points

    def _sizes(self) -> dict:
        return dict(extent=self.mix["extent"], batch=self.batch_size)

    def reference_loss(self, P, i: int):
        coords, feats, labels = self.batches[i]
        return ref_mink.loss(P, coords, feats, labels,
                             layers=self.config["layers"], **self._sizes())

    def flops(self, i: int) -> float:
        if not hasattr(self, "_flops"):
            self._flops = {}
        if i not in self._flops:
            cfg = self.config
            self._flops[i] = work.minkunet_train_flops(
                self.batches[i][0], in_channels=cfg["in_channels"],
                init_dim=cfg["init_dim"], planes=cfg["planes"],
                layers=cfg["layers"], out_channels=cfg["out_channels"],
                **self._sizes())
        return self._flops[i]
