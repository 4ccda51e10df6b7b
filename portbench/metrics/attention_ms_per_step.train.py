"""Device ms per training step in PyTorch's fused attention kernels
(flash, memory-efficient, cuDNN)."""

from harness import readers


def read(ctx):
    return readers.group_ms(ctx, "train", "attention")
