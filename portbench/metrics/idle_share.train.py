"""Idle share of the device over a traced stretch of training steps (%)."""

from harness import readers


def read(ctx):
    return readers.idle_share(ctx, "train")
