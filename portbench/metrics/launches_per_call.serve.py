"""Device operations per evaluation call (one batch)."""

from harness import readers


def read(ctx):
    return readers.launches(ctx, "serve")
