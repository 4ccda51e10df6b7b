"""Host ms per training step waiting for the step's scalars and statistics
(span `train.copy_wait`, median)."""

from harness import host_spans


def read(ctx):
    return host_spans.median_ms(ctx, "train", "train.copy_wait")
