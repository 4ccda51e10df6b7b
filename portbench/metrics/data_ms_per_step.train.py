"""Host ms per training step in the loader's next batch and its staging (span
`train.data`, median)."""

from harness import host_spans


def read(ctx):
    return host_spans.median_ms(ctx, "train", "train.data")
