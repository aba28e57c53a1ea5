"""Occupancy report of sparse tensors.

Port of `capacity_report` from
`mink_octtree_stablediffusion_tpu/utils/summary.py`: how full each
tensor's fixed-capacity buffer is.
"""

from __future__ import annotations


def capacity_report(*tensors, names=None) -> str:
    """One line per tensor: occupied rows / capacity and the share."""
    lines = ["tensor      occupied / capacity   util"]
    for i, t in enumerate(tensors):
        n = int(t.count())
        name = names[i] if names else f"tensor{i}"
        lines.append(f"{name:<10}  {n:>8} / {t.capacity:<8}  "
                     f"{n / max(t.capacity, 1):.1%}")
    return "\n".join(lines)
