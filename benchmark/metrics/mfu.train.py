"""Model FLOPs of the window over its seconds at the bf16 dense peak of
one H100 (989e12), in the train cells, in %."""

from benchmark import readings


def read(ctx):
    return readings.mfu(ctx, "train")
