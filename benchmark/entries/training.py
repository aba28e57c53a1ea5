"""What the training cells share: the window that enqueues the program's
train steps back to back, the first three steps that the reference
follows, and the comparison.

A cell's entry module subclasses ``TrainCell`` with ``build()`` (the
program's model, optimizer, step and the step's arguments for each
batch), ``reference_loss(P, i)`` (the plain loss of batch ``i``) and
``flops(i)`` (the model FLOPs of a step on batch ``i``).

Set-up builds one ``TrainState``, drives it through the first three
steps with the window's own call and feed (batches 0, 1, 2), and hands it
to the window, which goes on from batch 3 and cycles the batches.  It
keeps, per parameter, the norm of the first gradient as Adam holds it
after step 1 (its first moment over 1 − β1) and the norm of the change
after step 2.  The check runs the reference's first two steps from the
same weights on the same batches; ``readings`` gives every number it can
compare (the first step's loss, the first gradient's and the change's
norm gaps by the worst and by the median parameter, and the cells the
program dropped, where the cell counts them), and the cell's limits name
the ones compared.  The later steps' losses are not compared: under
Adam's first updates (every weight moves by about the learning rate, the
sign of a gradient that rounding decides included) they swing with the
rounding alone.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from .. import harness
from ..reference import sparse as sp
from ..reference.train import adam_steps

FIRST_STEPS = 3  # the set-up's steps, through the window's call
REF_STEPS = 2  # of them, the steps that the reference follows
BETA1 = 0.9


class TrainCell:
    tag = "train"

    def __init__(self, spec: dict, seed: int, device: torch.device):
        self.spec, self.seed, self.device = spec, seed, device
        self.config, self.mix = spec["config"], spec["mix"]
        self.limits = spec["limits"]

    # -- provided by the cell ----------------------------------------------------

    def build(self):
        """→ (module, TrainState, step, weights drawn, [(args, kwargs) a
        batch], [input voxels a batch])."""
        raise NotImplementedError

    def reference_loss(self, P, i: int):
        raise NotImplementedError

    def flops(self, i: int) -> float:
        raise NotImplementedError

    # -- set-up ---------------------------------------------------------------------

    def setup(self) -> None:
        (self.module, self.state, self.step, self.weights, self.feed,
         self.points) = self.build()
        names = {id(p): n for n, p in self.module.named_parameters()}
        self.names = names
        theta0 = {n: p.detach().clone()
                  for n, p in self.module.named_parameters()}
        self.losses = []
        for i in range(FIRST_STEPS):
            loss, _ = self.call(i)
            self.losses.append(loss)
            if i == 0:
                self.grad1 = self._first_gradient_norms()
            if i + 1 == REF_STEPS:
                self.change = {
                    n: torch.linalg.vector_norm(p.detach() - theta0[n])
                    for n, p in self.module.named_parameters()}
        del theta0

    def call(self, i: int):
        args, kw = self.feed[i % len(self.feed)]
        return self.step(self.state, *args, **kw)

    def _first_gradient_norms(self) -> Dict[str, torch.Tensor]:
        out = {}
        for group in self.state.optimizer.param_groups:
            for p in group["params"]:
                st = self.state.optimizer.state.get(p, {})
                if "exp_avg" in st:
                    out[self.names[id(p)]] = torch.linalg.vector_norm(
                        st["exp_avg"]) / (1 - BETA1)
                else:
                    out[self.names[id(p)]] = torch.zeros((), device=p.device)
        return out

    # -- the window ------------------------------------------------------------------

    def window(self, seconds: float, trace: bool) -> dict:
        clock = harness.Clock(self.device)
        host, pts = [], []
        i = FIRST_STEPS
        harness.sync(self.device)
        clock.mark()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            th = time.perf_counter()
            self.call(i)
            host.append(time.perf_counter() - th)
            clock.mark()
            pts.append(self.points[i % len(self.points)])
            i += 1
        steps = clock.seconds()
        total = sum(steps)
        self.window_flops = sum(self.flops(j % len(self.points))
                                for j in range(FIRST_STEPS, i)) \
            if trace else None
        return {"attempted": len(steps), "failed": 0,
                "train_points_per_s": sum(pts) / total,
                "train_step_p95_s": harness.percentile(steps, 95),
                "window_s": total, "host_enqueue_s": host,
                "step_s": steps}

    def profile(self) -> dict:
        """Ten steps under the profiler, with each kernel launch of B1–B3
        recorded (``launches``)."""
        from . import launches

        def run():
            for j in range(10):
                with harness.span("step"):
                    self.call(FIRST_STEPS + j)
        with launches.recorded() as self.launches:
            return harness.profile_slice(run)

    def trace_context(self) -> dict:
        from . import launches
        return {"tag": self.tag, "flops": self.window_flops,
                "fused_bound_s": launches.bound_seconds(
                    getattr(self, "launches", []))}

    # -- the check -------------------------------------------------------------------

    def release(self) -> None:
        self.losses = [float(v) for v in self.losses]
        self.grad1 = {k: float(v) for k, v in self.grad1.items()}
        self.change = {k: float(v) for k, v in self.change.items()}
        del self.module, self.state, self.step

    def reference(self, precision: str = "float32") -> dict:
        """The reference's first steps at ``precision`` → (each step's
        loss, the first gradient's norm a parameter, the change's norm a
        parameter, the parameters whose first gradient is not nought)."""
        sp.no_tf32()
        sp.set_precision(precision)
        try:
            theta0 = self.weights_for_reference()
            ref = adam_steps(theta0, [lambda P, i=i: self._loss(P, i)
                                      for i in range(REF_STEPS)],
                             lr=self.config["train"]["lr"])
        finally:
            sp.set_precision("float32")
        g = {k: float(v.double().norm()) for k, v in ref["grad1"].items()}
        d = {k: float((ref["params"][k] - theta0[k]).double().norm())
             for k in ref["params"]}
        med = sorted(g.values())[len(g) // 2]
        return {"loss": ref["loss"], "grad1": g, "change": d,
                "moved": [k for k in g if g[k] >= 1e-3 * med]}

    def _loss(self, P, i: int):
        with sp.cached_maps():
            return self.reference_loss(P, i)

    def compare(self, got: dict, ref: dict) -> List[dict]:
        """The compared numbers of ``got`` (the program's readings, or a
        control's) against the float32 reference's, with their limits."""
        values = {**readings(got, ref), **self.more_readings(got, ref)}
        return [{"name": k, "value": values[k], "limit": v}
                for k, v in self.limits.items()]

    def more_readings(self, got: dict, ref: dict) -> Dict[str, float]:
        """The cell's own compared numbers beside ``readings``'."""
        return {}

    def prog_readings(self) -> dict:
        return {"loss": self.losses, "grad1": self.grad1,
                "change": self.change}

    def check(self) -> List[dict]:
        return self.compare(self.prog_readings(), self.reference())

    def weights_for_reference(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.weights.items() if k in self.param_names}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> list:
    """``|prog − ref| / max(ref, the median leaf's ref)`` of each leaf of
    ``keep``, sorted."""
    med = sorted(ref[k] for k in keep)[len(keep) // 2]
    return sorted(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                  for k in keep)


def readings(got: dict, ref: dict) -> Dict[str, float]:
    """Every number a training check can compare: each step's loss gap,
    and of the first gradient's and of the change's norm gaps the worst
    and the median leaf's."""
    out = {f"loss{i + 1}_gap": sp.rel(a, b)
           for i, (a, b) in enumerate(zip(got["loss"], ref["loss"]))}
    # cells the program dropped (the reference drops none)
    out["lost_cells"] = float(got.get("lost_cells", 0))
    for name, keep in (("grad1", list(ref["grad1"])),
                       ("change", ref["moved"])):
        gaps = leaf_gaps(got[name], ref[name], keep)
        out[f"{name}_worst_gap"] = gaps[-1]
        out[f"{name}_gap"] = gaps[len(gaps) // 2]
    return out
