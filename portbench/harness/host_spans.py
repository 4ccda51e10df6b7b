"""What the readers of the port's host spans share: the median of one
span's durations (`mm_unet_tpu_torch/utils/spans.py`), one occurrence per
training step or evaluation call. The spans time the untraced steps of the
run (set-up's and the window's); under the profiler they leave their
registry alone. A program without the span facility gives None."""

from __future__ import annotations


def median_ms(ctx: dict, kind: str, name: str):
    """Median host ms of the span `name` per step or call; None for the
    other kind of cell, or where the span never ran."""
    if ctx["kind"] != kind:
        return None
    try:
        from mm_unet_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.median_ms(name)
