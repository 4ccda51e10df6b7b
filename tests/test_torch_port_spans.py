"""The port's host spans (`mm_unet_tpu_torch/utils/spans.py`) in its two
loops, on the CPU: a two-conv model through the real `train_step` with the
DiceFocal loss, `train_one_epoch` for 3 steps and `val_one_epoch` for 3
calls.

Without a profiler each span is counted once per step or call, and the
loop spans of a step do not overlap (a clock that counts its reads gives
each span one tick plus two for each span inside it). Under
`torch.profiler` the registry is left alone and every span is a host event
of the trace, the step's three inside `train.step`. The losses and metrics
are the same either way. The benchmark's six readers of the spans
(`portbench/metrics/`) give the medians for their own kind of cell and
None for the other."""

from __future__ import annotations

import itertools
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from mm_unet_tpu_torch.evaluate import val_one_epoch
from mm_unet_tpu_torch.train.loop import train_one_epoch
from mm_unet_tpu_torch.train.metrics import build_metrics
from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn
from mm_unet_tpu_torch.utils import spans

BENCH = Path(__file__).resolve().parent.parent / "portbench"

STEPS = 3
TRAIN_LOOP = ("train.data", "train.step", "train.copy_wait", "train.metrics")
TRAIN_STEP = ("train.forward", "train.backward", "train.optimizer")
EVAL_LOOP = ("eval.data", "eval.forward", "eval.copy_wait", "eval.metrics")
READERS = {  # metric -> (kind, span)
    "data_ms_per_step.train": ("train", "train.data"),
    "dispatch_ms_per_step.train": ("train", "train.step"),
    "copy_wait_ms_per_step.train": ("train", "train.copy_wait"),
    "dispatch_ms_per_call.serve": ("serve", "eval.forward"),
    "copy_wait_ms_per_call.serve": ("serve", "eval.copy_wait"),
    "metrics_ms_per_call.serve": ("serve", "eval.metrics"),
}


class TwoConv(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(4, 1, 3, padding=1))

    def forward(self, x):
        return self.body(x)


RATE = "Train/images_per_sec"  # the host's clock, never the same twice


class Losses:
    """A tracker that keeps what the loops log but the rate."""

    def __init__(self):
        self.logged = []

    def log(self, scalars, step):
        self.logged.append((step, {k: v for k, v in scalars.items() if k != RATE}))


def run_loops():
    """3 training steps and 3 evaluation calls from fixed weights and data;
    returns everything the loops logged and returned."""
    torch.manual_seed(0)
    model = TwoConv()
    rng = np.random.default_rng(0)
    batches = [{"image": rng.standard_normal((2, 3, 16, 16)).astype(np.float32),
                "label": (rng.random((2, 1, 16, 16)) > 0.5).astype(np.float32)}
               for _ in range(STEPS)]
    config = {"trainer": dict(lr=1e-2, warmup=1, num_epochs=2, steps_per_epoch=STEPS,
                              weight_decay=0.05, optimizer="adamw")}
    state = create_train_state(model, config)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    tracker = Losses()
    train = train_one_epoch(state, loss_fn, batches, build_metrics(), tracker=tracker)
    del train[RATE]
    val = val_one_epoch(model, loss_fn, lambda x, predictor: predictor(x), batches,
                        build_metrics(), tracker=tracker)
    params = [p.detach().clone() for p in model.parameters()]
    return tracker.logged, train, val, params


def test_spans_count_each_step_and_call():
    spans.reset()
    run_loops()
    snap = spans.snapshot()
    assert set(snap) == set(spans.NAMES)
    for name, (count, total, durations) in snap.items():
        assert count == STEPS and len(durations) == STEPS, name
        assert min(durations) >= 0 and total == sum(durations), name
        assert spans.median_ms(name) == pytest.approx(float(np.median(durations)) / 1e6)


def test_loop_spans_do_not_overlap(monkeypatch):
    """A clock that ticks once per read: a span that holds no other span's
    reads lasts one tick, `train.step` one plus two for each of its three."""
    monkeypatch.setattr(spans, "_now", itertools.count().__next__)
    spans.reset()
    run_loops()
    snap = spans.snapshot()
    for name in TRAIN_LOOP + TRAIN_STEP + EVAL_LOOP:
        want = 1 + 2 * len(TRAIN_STEP) if name == "train.step" else 1
        assert snap[name][2] == [want] * STEPS, name


def test_spans_under_the_profiler():
    spans.reset()
    plain = run_loops()
    before = spans.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run_loops()
    assert spans.snapshot() == before
    events = {}
    for e in prof.events():
        if e.name in spans.NAMES:
            events.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert set(events) == set(spans.NAMES)
    steps = events["train.step"]
    assert len(steps) == STEPS
    for name in TRAIN_STEP:
        assert len(events[name]) == STEPS
        for s, e in events[name]:
            assert any(s0 <= s and e <= e0 for s0, e0 in steps), name
    # the same arithmetic with and without the profiler
    assert plain[:3] == traced[:3]
    assert all(torch.equal(a, b) for a, b in zip(plain[3], traced[3]))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_readers(metric, monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))
    from harness.spec import metric_reader

    kind, name = READERS[metric]
    read = metric_reader(metric)
    spans.reset()
    assert read({"kind": kind, "steps": STEPS}) is None  # the span never ran
    run_loops()
    value = read({"kind": kind, "steps": STEPS})
    assert math.isfinite(value) and value == spans.median_ms(name)
    other = "serve" if kind == "train" else "train"
    assert read({"kind": other, "steps": STEPS}) is None


def test_readers_without_the_span_facility(monkeypatch):
    """A program that has no spans (a checkout before them) reads None."""
    monkeypatch.syspath_prepend(str(BENCH))
    from harness.spec import metric_reader

    import mm_unet_tpu_torch.utils

    monkeypatch.delattr(mm_unet_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "mm_unet_tpu_torch.utils.spans", None)
    for metric, (kind, _) in READERS.items():
        assert metric_reader(metric)({"kind": kind, "steps": STEPS}) is None


def test_registry_keeps_the_last_durations(monkeypatch):
    """Each name keeps its count and total over every block, the last KEEP
    durations, and nothing of a block left by an exception."""
    monkeypatch.setattr(spans, "KEEP", 4)
    monkeypatch.setattr(spans, "_now", itertools.count(step=10).__next__)
    spans.reset()
    for _ in range(6):
        with spans.span("x"):
            pass
    with pytest.raises(StopIteration):
        with spans.span("x"):
            next(iter(()))
    count, total, durations = spans.snapshot()["x"]
    assert (count, total, durations) == (6, 60, [10] * 4)
    assert spans.median_ms("x") == 1e-5 and spans.median_ms("y") is None
    spans.reset()
    assert spans.snapshot() == {}
