"""Parameter counts and occupancy reports.

Port of `mink_octtree_stablediffusion_tpu/utils/summary.py` (the
reference's torchsummary-style `utils/summary.py:12-135`): `count_params`
and `summary` count a module's parameters and not its buffers, as the JAX
package counts ``params`` and not ``batch_stats``; `capacity_report`
says how full each tensor's fixed-capacity buffer is.
"""

from __future__ import annotations

from typing import Dict, Iterable, Union

import torch

Params = Union[torch.nn.Module, Dict[str, torch.Tensor],
               Iterable[torch.Tensor]]


def _named(params: Params):
    if isinstance(params, torch.nn.Module):
        return list(params.named_parameters())
    if isinstance(params, dict):
        return list(params.items())
    return [(str(i), p) for i, p in enumerate(params)]


def count_params(params: Params) -> int:
    """Elements of a module's parameters (or of a dict or sequence of
    tensors)."""
    return int(sum(p.numel() for _, p in _named(params)))


def summary(params: Params, depth: int = 2, file=None) -> str:
    """Parameter counts summed over the first ``depth`` segments of each
    parameter's name, with the total."""
    rows: Dict[str, int] = {}
    for name, p in _named(params):
        prefix = "/".join(name.split(".")[:depth])
        rows[prefix] = rows.get(prefix, 0) + p.numel()
    total = sum(rows.values())
    width = max((len(k) for k in rows), default=10)
    lines = [f"{'module':<{width}}  params"]
    lines += [f"{k:<{width}}  {rows[k]:,}" for k in sorted(rows)]
    lines.append(f"{'TOTAL':<{width}}  {total:,}")
    out = "\n".join(lines)
    if file is not None:
        print(out, file=file)
    return out


def capacity_report(*tensors, names=None) -> str:
    """One line per tensor: occupied rows / capacity and the share."""
    lines = ["tensor      occupied / capacity   util"]
    for i, t in enumerate(tensors):
        n = int(t.count())
        name = names[i] if names else f"tensor{i}"
        lines.append(f"{name:<10}  {n:>8} / {t.capacity:<8}  "
                     f"{n / max(t.capacity, 1):.1%}")
    return "\n".join(lines)
