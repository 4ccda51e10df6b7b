"""What the per-layer metrics' readers (`metrics/<name>.py`) share. Each
takes the context of a traced run (`run.py::traced`): the cell's kind
("train" or "serve"), the steps traced, the `Trace`, the least milliseconds
per step of each kernel family, the products of a step, the peak they are
priced at and the untraced window's steps per second. A reader returns
None where it finds nothing to read."""

from __future__ import annotations


def idle_share(ctx: dict, kind: str):
    """% of the traced window in which no device operation ran."""
    if ctx["kind"] != kind:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def launches(ctx: dict, kind: str):
    """Device operations (kernels, memsets, copies) per step or call."""
    return ctx["trace"].launches / ctx["steps"] if ctx["kind"] == kind else None


def mfu(ctx: dict, kind: str):
    """% of the peak: a step's products over its time in the untraced window."""
    if ctx["kind"] != kind:
        return None
    return 100.0 * ctx["flops_per_step"] * ctx["steps_per_s"] / ctx["peak_flops"]


def roofline(ctx: dict, kind: str, family: str):
    """% of the family's device time that its least time is; None where the
    configuration gives the family no launches."""
    ms = ctx["trace"].family_ms(family)
    least = ctx["least_ms_per_step"].get(family)
    if ctx["kind"] != kind or ms <= 0 or least is None:
        return None
    return 100.0 * least * ctx["steps"] / ms


def group_ms(ctx: dict, kind: str, group: str):
    """Device ms per step in one group of kernel names."""
    ms = ctx["trace"].group_ms.get(group, 0.0)
    return ms / ctx["steps"] if ctx["kind"] == kind and ms > 0 else None
