"""A training step's model products over its time, against the configuration's peak (%)."""

from harness import readers


def read(ctx):
    return readers.mfu(ctx, "train")
