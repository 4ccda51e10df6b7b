"""Device ms per training step in AdamW's fused kernels."""

from harness import readers


def read(ctx):
    return readers.group_ms(ctx, "train", "optimizer (AdamW)")
