"""Named spans of the port's loops: the host's time in each phase of a
training step or an evaluation call.

`with span(name):` times its block. With no `torch.profiler` running it
adds the block's duration to a registry by name: a count, a total and the
last `KEEP` durations, in nanoseconds (two clock reads and an append). A
block left by an exception is not counted. With a profiler running it
records the block as a host operation named `name` instead, so that it
shows among the trace's host events, on the kernels' clock, and leaves the
registry alone: the profiler slows every host operation, so its samples
would read long. The operation is recorded in an operator's scope
(`torch._C._profiler._RecordFunctionFast`), not in the user scope of
`torch.profiler.record_function`: on the card a user-scope range also gets
an annotation on the device's timeline over the kernels it issued, which a
reader of the trace's device events would count as device work.

The loops' spans (`NAMES`), one occurrence per step or call each:

- `train/loop.py::train_one_epoch`, in order and not overlapping:
  `train.data` (the loader's next batch, `shard_batch` and `stage`),
  `train.step` (`train_step` and the two `HostCopy` issues),
  `train.copy_wait` (the step's `HostCopy.get`s), `train.metrics` (the
  rest of the step's read-back: the data-parallel gathers, the metrics'
  `update_stats`, the print and the tracker);
- `train/trainer.py::train_step`, inside `train.step`: `train.forward`
  (the model and the loss), `train.backward` (the backward pass and the
  data-parallel gradient all-reduce), `train.optimizer` (the optimizer's
  step);
- `evaluate.py::val_one_epoch`, in order and not overlapping: `eval.data`
  (the loader and `stage`), `eval.forward` (the inferer, the loss,
  `seg_stats`, the threshold where a metric needs the masks, and the
  `HostCopy` issue), `eval.copy_wait` (`HostCopy.get`), `eval.metrics`
  (`update_stats` of the metrics that take the counts, the updates of
  those that need the masks, the print and the tracker).

Not in `NAMES`, since it does not occur in every call: `eval.masks`,
inside `eval.metrics`, the updates of the metrics that need the masks
themselves (HD95); counted once per call that reads masks back, never
where every metric takes `seg_stats`' counts.
"""

from __future__ import annotations

import statistics
from collections import deque
from time import perf_counter_ns as _now

import torch

KEEP = 4096  # durations kept per name
NAMES = ("train.data", "train.step", "train.forward", "train.backward", "train.optimizer",
         "train.copy_wait", "train.metrics",
         "eval.data", "eval.forward", "eval.copy_wait", "eval.metrics")

_registry: dict[str, list] = {}  # name -> [count, total_ns, deque of durations]
_profiling = torch._C._autograd._profiler_enabled
_HostOp = torch._C._profiler._RecordFunctionFast


class span:
    """Times the block as the span `name` (see the module's docstring)."""

    __slots__ = ("name", "t0", "traced")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiling():
            self.traced = _HostOp(self.name)
            self.traced.__enter__()
        else:
            self.traced = None
            self.t0 = _now()

    def __exit__(self, *exc):
        if self.traced is not None:
            return self.traced.__exit__(*exc)
        if exc[0] is None:
            d = _now() - self.t0
            entry = _registry.get(self.name)
            if entry is None:
                entry = _registry[self.name] = [0, 0, deque(maxlen=KEEP)]
            entry[0] += 1
            entry[1] += d
            entry[2].append(d)
        return False


def snapshot() -> dict:
    """{name: (count, total_ns, [the last KEEP durations in ns])}."""
    return {k: (c, t, list(d)) for k, (c, t, d) in _registry.items()}


def median_ms(name: str):
    """The median of the span's kept durations in ms; None where it never ran."""
    entry = _registry.get(name)
    return statistics.median(entry[2]) / 1e6 if entry else None


def reset() -> None:
    _registry.clear()
