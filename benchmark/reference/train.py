"""Training steps in plain PyTorch: a loss over named parameters, its
gradients by autograd, and Adam (β 0.9 / 0.999, ε 1e-8 added to the
square root of the bias-corrected second moment)."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch


def adam_steps(params: Dict[str, torch.Tensor], losses: List[Callable],
               lr: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> dict:
    """Run one Adam step for each loss closure ``loss(P) -> (loss, aux)``
    from ``params`` (float32 copies are taken) → {"loss": [each step's
    loss], "grad1": {name: the first step's gradient}, "params": {name:
    the parameters after the last step}}."""
    P = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    out = {"loss": [], "grad1": None}
    for t, fn in enumerate(losses, start=1):
        loss, _ = fn(P)
        grads = torch.autograd.grad(loss, list(P.values()),
                                    allow_unused=True)
        out["loss"].append(float(loss.detach()))
        g = {k: (torch.zeros_like(P[k]) if gi is None else gi)
             for k, gi in zip(P, grads)}
        if out["grad1"] is None:
            out["grad1"] = g
        with torch.no_grad():
            for k in P:
                m[k].mul_(b1).add_((1 - b1) * g[k])
                v2[k].mul_(b2).add_((1 - b2) * g[k] ** 2)
                mh = m[k] / (1 - b1 ** t)
                vh = v2[k] / (1 - b2 ** t)
                P[k] -= lr * mh / (vh.sqrt() + eps)
        del loss, grads, g
    out["params"] = {k: p.detach() for k, p in P.items()}
    return out
