"""The CUDA graph replays of the UNet that the program counted in each
DDIM step (`sample.step`) of the profiled request, their median: 1 where
each step replays the UNet's graph, 0 where it runs the forward eagerly."""

from benchmark import harness, program_trace


def read(ctx):
    values = program_trace.per_span(
        ctx, "gen", "sample.step",
        lambda rec, i: rec.counter("unet.graph_replay", i))
    return harness.median(values) if values else None
