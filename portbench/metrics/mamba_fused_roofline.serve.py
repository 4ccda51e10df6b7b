"""Kernel 1 (fused Mamba scan forward) in evaluation: least time over device time (%)."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "serve", "mamba_fused")
