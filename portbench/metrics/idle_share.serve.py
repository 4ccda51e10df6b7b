"""Idle share of the device over a traced stretch of evaluation calls (%)."""

from harness import readers


def read(ctx):
    return readers.idle_share(ctx, "serve")
