"""Device ms per training step in cuDNN and xmma convolution kernels."""

from harness import readers


def read(ctx):
    return readers.group_ms(ctx, "train", "convolution (cuDNN)")
