"""B1–B3's share of their roofline in the train cells from the work the
program counted at each launch: Σ over the profiled slice's launches of
max(ops / 989e12, bytes / 3.35e12) over the device time of the fused conv
kernels, in %."""

from benchmark import program_trace


def read(ctx):
    return program_trace.counted_roofline(ctx, "train")
