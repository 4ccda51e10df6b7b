"""Kernels 3 and 4 (tap-conv, forward and backward) in training: least time over device time (%)."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "train", "tap_conv")
