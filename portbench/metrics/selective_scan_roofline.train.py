"""Kernels 5 and 6 (the selective scan, forward and backward) in training:
least time over device time (%)."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "train", "selective_scan")
