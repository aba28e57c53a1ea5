"""The host µs of the profiled slice's train steps (the program's
`train.step` spans) over the device operations the slice ran."""

from benchmark import program_trace


def read(ctx):
    return program_trace.host_us_per_launch(ctx, "train")
