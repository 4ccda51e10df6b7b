"""Host ms per evaluation call waiting for the call's loss, prediction and
labels (span `eval.copy_wait`, median)."""

from harness import host_spans


def read(ctx):
    return host_spans.median_ms(ctx, "serve", "eval.copy_wait")
