"""Launches of the fused conv kernels B1–B3, recorded with their operands
while a profiled slice runs.

The program's operators call ``ops.fused_conv._launch`` (B1, and B2 with
``transpose_weight``) and ``_launch_dkernel`` (B3) by module-global name;
``recorded()`` wraps both for the block and keeps each launch's
coordinate operands (no feature data is copied), from which
``benchmark.work`` counts the operations and bytes after the slice.
"""

from __future__ import annotations

from contextlib import contextmanager

from .. import work


@contextmanager
def recorded():
    from mink_octtree_stablediffusion_tpu_torch.ops import fused_conv as fc

    launch, launch_dk = fc._launch, fc._launch_dkernel
    calls: list = []

    def rec_launch(features, kernel, in_keys, out_coords, out_valid, offs,
                   s_in, cells, compute_dtype, transpose_weight=False,
                   stage="full"):
        calls.append(("B2" if transpose_weight else "B1", features.shape,
                      kernel, in_keys, out_coords, out_valid, offs,
                      tuple(s_in), tuple(cells)))
        return launch(features, kernel, in_keys, out_coords, out_valid,
                      offs, s_in, cells, compute_dtype,
                      transpose_weight=transpose_weight, stage=stage)

    def rec_launch_dk(features, g, in_keys, out_coords, out_valid, offs,
                      s_in, cells, compute_dtype):
        calls.append(("B3", features.shape, g.shape, in_keys, out_coords,
                      out_valid, offs, tuple(s_in), tuple(cells)))
        return launch_dk(features, g, in_keys, out_coords, out_valid, offs,
                         s_in, cells, compute_dtype)

    fc._launch, fc._launch_dkernel = rec_launch, rec_launch_dk
    try:
        yield calls
    finally:
        fc._launch, fc._launch_dkernel = launch, launch_dk


def bound_seconds(calls) -> float:
    """Σ over the launches of the least time each could take on one H100."""
    total = 0.0
    for kind, fshape, w, in_keys, out_coords, out_valid, offs, s_in, cells \
            in calls:
        ops, moved = work.launch_work(kind, fshape, w, in_keys, out_coords,
                                      out_valid, offs, s_in, cells)
        total += work.bound_seconds(ops, moved)
    return total
