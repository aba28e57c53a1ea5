"""B1–B3's share of their roofline in the gen cells: Σ over the profiled
slice's launches of max(ops / 989e12, bytes / 3.35e12), over the device
time of the fused conv kernels, in %."""

from benchmark import readings


def read(ctx):
    return readings.fused_roofline(ctx, "gen")
