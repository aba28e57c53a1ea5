"""Point-cloud renders to PNG.

Port of `mink_octtree_stablediffusion_tpu/utils/viz.py`: a matplotlib
scatter per cloud (the reference's open3d + matplotlib render of
`examples/ae_res.py:865-886,941-952`, reconstruction beside input).
matplotlib is imported inside ``render_pointclouds``, so that the package
imports where it is not installed.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def render_pointclouds(clouds: Sequence[np.ndarray], path: str,
                       titles: Optional[Sequence[str]] = None,
                       resolution: Optional[int] = None) -> str:
    """Render one subplot per cloud ([N, 3] int/float arrays) to ``path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(clouds)
    fig = plt.figure(figsize=(4 * n, 4))
    for i, pts in enumerate(clouds):
        ax = fig.add_subplot(1, n, i + 1, projection="3d")
        pts = np.asarray(pts)
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1.0,
                       c=pts[:, 2], cmap="viridis")
        if resolution:
            ax.set_xlim(0, resolution)
            ax.set_ylim(0, resolution)
            ax.set_zlim(0, resolution)
        if titles:
            ax.set_title(titles[i])
        ax.set_axis_off()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def sparse_tensor_clouds(st, max_instances: int = 4):
    """Split a SparseTensor's (or a SparseGrid's) valid coordinates into
    per-instance [N, 3] numpy clouds (the reference renders batch 0's
    decomposition)."""
    grid = getattr(st, "grid", st)
    c = grid.coords.detach().cpu().numpy()
    v = grid.valid.detach().cpu().numpy()
    return [c[v & (c[:, 0] == b)][:, 1:]
            for b in range(min(grid.batch_size, max_instances))]
