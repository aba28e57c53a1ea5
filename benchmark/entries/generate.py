"""Shape generation through ``serve.build_generate_fn`` (encode the
conditioning shapes, denoise the latent with the UNet and DDIM, decode
with the pruning decoder): one client sends requests back to back, each
``per_batch`` conditioning shapes of the mix with fresh noise, which the
benchmark draws from the seed and hands to the program (``init_noise``).

The check takes one request drawn from the seed, which the window
recorded by forward hooks (references to its tensors, nothing copied or
waited for), and compares it two ways.  Free-running: the reference
encodes the request's voxels, runs the whole DDIM chain from the same
noise on its own latents and decodes on its own kept sets; the
program's final latent and its generated cells against the reference's
(``chain_gap``, ``set_gap``).  Step by step, to say where a fault lies:
the encoder's latent; at steps drawn from the seed, the UNet's noise
prediction on the program's own noisy latent and the program's next
latent against the DDIM step from the program's prediction; the
decoder's logits at every level, grown from the program's own kept
cells; and every set the program made against the reference's growth and
the choice its own logits make.
"""

from __future__ import annotations

import random
import time
from typing import List

import torch

from .. import harness, traffic
from ..reference import sparse as sp
from ..reference import unet as ref_unet
from ..reference import vae as ref_vae
CHECKED_STEPS = 4
PROFILED_STEPS = 3


class Cell:
    tag = "gen"
    checks_the_window = True  # the check reads a request of the window

    def __init__(self, spec: dict, seed: int, device: torch.device):
        self.spec, self.seed, self.device = spec, seed, device
        self.config, self.mix = spec["config"], spec["mix"]
        self.limits = spec["limits"]

    # -- set-up ---------------------------------------------------------------------

    def setup(self) -> None:
        import mink_octtree_stablediffusion_tpu_torch as mp

        dev, cfg, mix = self.device, self.config, self.mix
        if dev.type == "cuda":
            mp.utils.cuda_build.build()
        self.mp = mp
        cap, b = mix["capacity"], mix["per_batch"]
        # the program's own buffer schedule for generation; the clamp of
        # the kept cells a level is the configuration's (``max_keep``)
        _, dec_caps = mp.serve.capacities(cap)
        self.max_keep = dec_caps[1] // 8
        vae, unet = mp.serve.generation_models(
            input_capacity=cap, batch_size=b,
            vae_channel=tuple(cfg["vae_channels"]),
            unet_channel=tuple(cfg["unet_channels"]), group=cfg["group"],
            max_keep=self.max_keep, device=dev, seed=0)
        gen = harness.seeded(self.seed, dev)
        self.w_vae = harness.draw_weights(vae, gen)
        self.w_unet = harness.draw_weights(unet, gen)
        vae.load_state_dict(self.w_vae)
        unet.load_state_dict(self.w_unet)
        self.vae, self.unet = vae, unet
        self.fn = self._generate_fn(cfg["sample_steps"])
        self.inputs, self.shapes = [], []
        for batch in traffic.make_batches(mix, self.seed):
            coords, valid, _, _ = traffic.collate(batch, cap)
            self.inputs.append((coords, valid))
            self.shapes.append(len(batch))
        spec = mp.serve.noise_spec(self.fn, *self.inputs[0])
        if spec["step_noise"]:
            raise ValueError("the cell's scheduler draws noise a step")
        self.noise_shape = tuple(spec["shape"])
        # the warm-up: one request cut to 2 steps (every step has the
        # shapes of the others)
        self._generate_fn(2)(*self.inputs[0], init_noise=self._noise(-1))
        harness.sync(dev)
        self._hook()

    def _generate_fn(self, steps: int):
        cfg, mix = self.config, self.mix
        return self.mp.serve.build_generate_fn(
            self.vae, self.unet, self.mp.diffusion.DDIMScheduler.create(),
            input_capacity=mix["capacity"], batch_size=mix["per_batch"],
            resolution=mix["resolution"], vae_scale=cfg["vae_scale"],
            sample_steps=steps, device=self.device)

    def _noise(self, r: int) -> torch.Tensor:
        """Request ``r``'s initial latent noise, N(0, 1) a row of the
        program's latent buffer."""
        gen = harness.seeded(self.seed * 1000003 + r + 1, self.device)
        return torch.randn(self.noise_shape, generator=gen,
                           device=self.device)

    def _hook(self) -> None:
        """Forward hooks that keep references to what the first two
        requests make (the check draws one of them): the UNet's input and
        output at every step, the encoder's latent, the decoder's input,
        each level's logits and the cells it kept (their coordinates)."""
        self.cur = None
        dec = self.vae.decoder

        def keep(key, what):
            def hook(mod, args, out=None):
                if self.cur is not None and self.cur["request"] < 2:
                    self.cur.setdefault(key, []).append(what(args, out))
            return hook

        def grid_of(args, out):
            return args[0].grid
        self.handles = [
            self.vae.encoder.register_forward_hook(
                keep("enc", lambda a, o: o[0])),
            self.unet.register_forward_hook(
                keep("unet", lambda a, o: (a[0], a[1], o))),
            dec.register_forward_pre_hook(keep("dec_in", lambda a, o: a[0]))]
        for lvl in range(1, 5):
            self.handles.append(getattr(dec, f"block{lvl}_cls")
                                .register_forward_hook(
                                    keep(f"cls{lvl}", lambda a, o: o)))
        for lvl in range(2, 5):
            self.handles.append(getattr(dec, f"block{lvl}")
                                .register_forward_pre_hook(
                                    keep(f"in{lvl}", grid_of)))

    # -- the window ------------------------------------------------------------------

    def window(self, seconds: float, trace: bool) -> dict:
        """Requests back to back; the next one starts while it would end
        inside ``seconds`` by the last one's time (the first always
        starts), so that a run keeps to its time."""
        spans: dict = {}
        undo = self._spans(spans, self.fn.program) if trace else None
        self.records = []
        done = last = 0.0
        walls = []
        harness.sync(self.device)
        t0 = time.perf_counter()
        r = 0
        while r == 0 or time.perf_counter() - t0 + last <= seconds:
            t = time.perf_counter()
            self.cur = {"request": r, "noise": self._noise(r)}
            i = r % len(self.inputs)
            self.cur["out"] = self.fn(*self.inputs[i],
                                      init_noise=self.cur["noise"])
            harness.sync(self.device)
            if r < 2:
                self.records.append(self.cur)
            self.cur = None
            done += self.shapes[i]
            last = time.perf_counter() - t
            walls.append(last)
            r += 1
        total = time.perf_counter() - t0
        if undo:
            undo()
        self.window_flops = self._request_flops() * r if trace else None
        return {"attempted": r, "failed": 0, "gen_shapes_per_s": done / total,
                "window_s": total, "spans": spans,
                "sample_steps": self.config["sample_steps"],
                "notes": {"request_s": walls}}

    def _spans(self, record, program):
        """Spans around ``program``'s encode, denoising loop and decode
        (with ``record``: synchronised at their ends, their seconds
        appended there) → a function that removes them."""
        serve = self.mp.serve
        latent, sample, decode = (program.latent, serve.sample_latent,
                                  self.vae.decode)

        def wrap(name, fn):
            def run(*a, **kw):
                with harness.span(name, record, self.device):
                    return fn(*a, **kw)
            return run
        program.latent = wrap("encode", latent)
        serve.sample_latent = wrap("denoise", sample)
        self.vae.decode = wrap("decode", decode)

        def undo():
            del program.latent, self.vae.decode
            serve.sample_latent = sample
        return undo

    def profile(self) -> dict:
        """Encode, 3 DDIM steps and decode of one request under the
        profiler, each launch of B1–B3 recorded."""
        from . import launches

        fn = self._generate_fn(PROFILED_STEPS)
        undo = self._spans(None, fn.program)
        for h in self.handles:
            h.remove()
        try:
            with launches.recorded() as self.launches:
                return harness.profile_slice(lambda: fn(
                    *self.inputs[0], init_noise=self._noise(-2)))
        finally:
            undo()

    def _request_flops(self) -> float:
        """Model FLOPs of a request (the reference's count on its first
        recorded one): the encoder and the UNet at every step; the decoder
        is left out (its cells depend on the weights)."""
        rec = self.records[0]
        grid, x, t = self._unet_input(rec, 0)
        with torch.no_grad(), sp.counting() as c:
            self._reference_unet(self.w_unet)(x, grid, t)
        per_step = c[0]
        with torch.no_grad(), sp.counting() as c:
            ref_vae.encode(self.w_vae, self._input_grid(rec), training=False)
        return c[0] + per_step * self.config["sample_steps"]

    def trace_context(self) -> dict:
        from . import launches
        return {"tag": self.tag, "flops": self.window_flops,
                "fused_bound_s": launches.bound_seconds(
                    getattr(self, "launches", []))}

    # -- the check -------------------------------------------------------------------

    def release(self) -> None:
        for h in self.handles:
            h.remove()
        rng = random.Random(self.seed)
        self.checked = self.records[rng.randrange(len(self.records))]
        steps = self.config["sample_steps"]
        inner = rng.sample(range(1, steps - 1), min(CHECKED_STEPS - 2,
                                                    steps - 2))
        self.steps = sorted({0, steps - 1, *inner})
        self.records = [self.checked]
        del self.fn, self.vae, self.unet

    def _input_grid(self, rec) -> sp.Grid:
        coords, valid = self.inputs[rec["request"] % len(self.inputs)]
        c = torch.as_tensor(coords[valid], device=self.device)
        return sp.make_grid(c, 1, self.mix["resolution"],
                            self.mix["per_batch"])

    def _grid(self, st) -> sp.Grid:
        return sp.Grid(st.grid.coords[st.grid.valid].long(),
                       int(st.grid.stride[0]), self.mix["resolution"],
                       self.mix["per_batch"])

    def _unet_input(self, rec, i: int):
        x, t, _ = rec["unet"][i]
        return self._grid(x), x.features[x.grid.valid], int(t[0])

    def _reference_unet(self, P):
        return ref_unet.UNet(P, self.config["unet_channels"],
                             self.config["group"])

    def _decoder_levels(self, rec) -> list:
        levels = []
        for lvl in range(1, 5):
            out = rec[f"cls{lvl}"][0]
            v = out.grid.valid
            if lvl < 4:
                nxt = rec[f"in{lvl + 1}"][0]
                kept = nxt.coords[nxt.valid]
            else:
                coords, valid = rec["out"]
                kept = coords[valid]
            levels.append((out.grid.coords[v].long(), out.features[v, 0],
                           kept.long()))
        return levels

    def reference(self, precision: str = "float32") -> dict:
        """The reference's readings on the checked request at
        ``precision``: free-running, the final latent and the generated
        cells of its own chain from the request's noise; step by step, the
        latent mean, at the checked steps the noise prediction and the DDIM
        step from the program's own prediction, the decoder's logits at
        each level (on the program's candidates), and the cells where the
        program's sets differ from the reference's."""
        rec = self.checked
        sp.no_tf32()
        sp.set_precision(precision)
        out = {}
        try:
            with torch.no_grad():
                inp = self._input_grid(rec)
                lat, mean, _ = ref_vae.encode(self.w_vae, inp,
                                              training=False)
                mean_p, = rec["enc"]
                idx, miss = ref_vae.rows_of(lat, self._grid(mean_p).coords)
                out["mean"] = mean[idx.clamp(min=0)]
                out["mismatch"] = miss
                unet = self._reference_unet(self.w_unet)
                ddim = ref_unet.DDIM(self.config["sample_steps"])
                with sp.cached_maps():
                    out["z"], out["final"] = self._chain(rec, unet, ddim,
                                                         lat, inp)
                    out["eps"] = {}
                    for i in self.steps:
                        grid, x, t = self._unet_input(rec, i)
                        out["mismatch"] += int(t != ddim.timesteps[i])
                        out["eps"][i] = unet(x, grid, t)
                out["steps"] = {}
                for i in self.steps:
                    eps_p = rec["unet"][i][2]
                    _, x, _ = self._unet_input(rec, i)
                    out["steps"][i] = ddim.step(sp.rounded(
                        eps_p.features[eps_p.grid.valid]), i, sp.rounded(x))
                z, = rec["dec_in"]
                levels = self._decoder_levels(rec)
                out["logits"], miss = ref_vae.decode_following(
                    self.w_vae, self._grid(z), z.features[z.grid.valid],
                    levels, self.max_keep)
                out["mismatch"] += miss
        finally:
            sp.set_precision("float32")
        return out

    def _chain(self, rec, unet, ddim, lat: sp.Grid, inp: sp.Grid):
        """The reference's own generation from the request's noise: every
        DDIM step of its UNet on its latent cells, then its decoder on its
        own kept sets → ((latent cells, the final latent over the VAE
        scale), the generated cells)."""
        mean_p, = rec["enc"]
        rows = mean_p.grid.valid.nonzero()[:, 0]
        idx, _ = ref_vae.rows_of(lat, mean_p.grid.coords[rows].long())
        x = torch.zeros((len(lat), rec["noise"].shape[1]),
                        device=self.device)
        x[idx[idx >= 0]] = rec["noise"][rows[idx >= 0]]
        for i, t in enumerate(ddim.timesteps):
            x = ddim.step(unet(x, lat, t), i, x)
        z = x / self.config["vae_scale"]
        _, _, final, _ = ref_vae.decode(self.w_vae, lat, z, inp,
                                        self.max_keep, training=False)
        return (lat.coords, z), final.coords

    def _next_latent(self, rec, i: int) -> torch.Tensor:
        """The latent the program's step ``i`` made: the UNet's input at
        the next step, or the decoder's input times the VAE scale."""
        if i + 1 < len(rec["unet"]):
            return self._unet_input(rec, i + 1)[1]
        z, = rec["dec_in"]
        return z.features[z.grid.valid] * self.config["vae_scale"]

    def prog_readings(self) -> dict:
        rec = self.checked
        mean_p, = rec["enc"]
        eps = {}
        for i in self.steps:
            e = rec["unet"][i][2]
            eps[i] = e.features[e.grid.valid]
        z, = rec["dec_in"]
        coords, valid = rec["out"]
        return {"mean": mean_p.features[mean_p.grid.valid], "eps": eps,
                "steps": {i: self._next_latent(rec, i) for i in self.steps},
                "logits": [lg for _, lg, _ in self._decoder_levels(rec)],
                "z": (self._grid(z).coords, z.features[z.grid.valid]),
                "final": coords[valid].long()}

    def _cells(self, coords: torch.Tensor, stride: int) -> sp.Grid:
        return sp.make_grid(coords, stride, self.mix["resolution"],
                            self.mix["per_batch"])

    def compare(self, got: dict, ref: dict) -> List[dict]:
        def rel(a, b):
            return float((a - b).norm() / b.norm().clamp(min=1e-30))
        (ref_c, ref_z), (got_c, got_z) = ref["z"], got["z"]
        idx, _ = ref_vae.rows_of(self._cells(ref_c, 8), got_c)
        z = torch.zeros_like(ref_z)
        z[idx[idx >= 0]] = got_z[idx >= 0].float()
        _, lost = ref_vae.rows_of(self._cells(ref["final"], 1), got["final"])
        union = (len(ref["final"]) + len(got["final"]) + lost) / 2
        values = {
            "chain_gap": rel(z, ref_z),
            "set_gap": lost / max(union, 1.0),
            "latent_gap": rel(got["mean"], ref["mean"]),
            "eps_gap": max(rel(got["eps"][i], ref["eps"][i])
                           for i in self.steps),
            "logit_gap": max(rel(a, b) for a, b in zip(got["logits"],
                                                        ref["logits"])),
            "step_gap": max(rel(got["steps"][i], ref["steps"][i])
                            for i in self.steps),
            "set_mismatch": float(ref["mismatch"])}
        return [{"name": k, "value": values[k], "limit": v}
                for k, v in self.limits.items()]

    def check(self) -> List[dict]:
        return self.compare(self.prog_readings(), self.reference())
