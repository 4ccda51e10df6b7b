"""Kernels 1 and 2 (fused Mamba scan, forward and backward) in training:
least time over device time (%)."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "train", "mamba_fused")
