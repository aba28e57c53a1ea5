"""The host ms of the program's `unet.forward` spans in each DDIM step
(`sample.step`) of the profiled request, their median."""

from benchmark import program_trace


def read(ctx):
    return program_trace.host_ms(ctx, "gen", "sample.step", "unet.forward")
