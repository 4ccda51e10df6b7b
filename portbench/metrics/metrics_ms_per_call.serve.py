"""Host ms per evaluation call in the seven metrics' updates, the print and
the tracker (span `eval.metrics`, median)."""

from harness import host_spans


def read(ctx):
    return host_spans.median_ms(ctx, "serve", "eval.metrics")
