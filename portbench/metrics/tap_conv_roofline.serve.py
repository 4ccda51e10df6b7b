"""Kernel 3 (tap-conv forward) in evaluation: least time over device time (%)."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "serve", "tap_conv")
