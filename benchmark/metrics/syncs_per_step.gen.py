"""The syncs (reads where the host waits for the card) that the program
counted in each DDIM step (`sample.step`) of the profiled request, their
median."""

from benchmark import program_trace


def read(ctx):
    return program_trace.syncs_per(ctx, "gen", "sample.step")
