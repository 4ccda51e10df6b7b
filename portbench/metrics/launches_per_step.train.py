"""Device operations per training step."""

from harness import readers


def read(ctx):
    return readers.launches(ctx, "train")
