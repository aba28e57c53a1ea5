"""The host ms of the program's `train.backward` span (`loss.backward()`)
in each train step of the profiled slice, their median."""

from benchmark import program_trace


def read(ctx):
    return program_trace.host_ms(ctx, "train", "train.step", "train.backward")
