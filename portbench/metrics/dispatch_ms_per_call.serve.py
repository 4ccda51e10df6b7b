"""Host ms per evaluation call in issuing the inferer, the loss, the threshold
and the read-back copy (span `eval.forward`, median)."""

from harness import host_spans


def read(ctx):
    return host_spans.median_ms(ctx, "serve", "eval.forward")
