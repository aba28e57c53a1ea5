"""The host ms of the program's `train.forward` span (the loss function's
forward) in each train step of the profiled slice, their median."""

from benchmark import program_trace


def read(ctx):
    return program_trace.host_ms(ctx, "train", "train.step", "train.forward")
