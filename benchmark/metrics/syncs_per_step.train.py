"""The syncs (reads where the host waits for the card) that the program
counted in each train step of the profiled slice, their median."""

from benchmark import program_trace


def read(ctx):
    return program_trace.syncs_per(ctx, "train", "train.step")
