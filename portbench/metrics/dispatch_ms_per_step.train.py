"""Host ms per training step in issuing `train_step` and its read-back copies
(span `train.step`, median)."""

from harness import host_spans


def read(ctx):
    return host_spans.median_ms(ctx, "train", "train.step")
