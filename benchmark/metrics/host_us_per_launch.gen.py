"""The host µs of the profiled request (the program's `serve.generate`
span) over the device operations it ran."""

from benchmark import program_trace


def read(ctx):
    return program_trace.host_us_per_launch(ctx, "gen")
