"""The share of the profiled slice in which no kernel ran on the card, in
the train cells, in %."""

from benchmark import readings


def read(ctx):
    return readings.idle_share(ctx, "train")
