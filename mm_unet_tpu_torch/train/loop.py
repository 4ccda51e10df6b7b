"""The training epoch (counterpart of `train.py:32-84::train_one_epoch`).

Each batch goes through `train_step`; the metric statistics feed the numpy
metrics' `update_stats` (`train/metrics.py`). The running step is the train
state's `step`.

Under data parallelism (`TrainState.dp`) every rank reads the same global
batch and keeps its rows (`parallel/mesh.py::shard_batch`); the step's
scalars are summed and its metric statistics gathered over the ranks before
they are logged, so that the printed losses and the epoch's metrics are the
one-process run's. The stop flag is agreed at every step boundary
(`stop_requested`): a signal that reaches any rank stops them all there.

On the card the loop keeps one step in flight, as the JAX loop does
(`train.py:40-42`). Each batch is staged in pinned host memory and copied
with `non_blocking=True` (`stage`). A step's scalars and metric statistics
are copied into pinned host buffers, non-blocking, behind that step, and an
event is recorded after the copy (`HostCopy`). The host reads them only
after it has issued the next step, and then waits on that event alone, so
nothing waits on the whole stream until the epoch's closing synchronise.

Each step's phases are timed as the spans `train.data`, `train.step`,
`train.copy_wait` and `train.metrics` (`utils/spans.py`).

A language model's batch is {"tokens": (B, L) ids}: the ids are both its
input and its target, the step has no metric statistics
(`trainer.train_step`), and the epoch counts sequences where it counts
images.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

from mm_unet_tpu_torch.parallel.mesh import shard_batch
from mm_unet_tpu_torch.train.trainer import TrainState, train_step
from mm_unet_tpu_torch.utils.spans import span


def stage(x, device: torch.device) -> torch.Tensor:
    """A batch array on `device`, integers (a language model's token ids) as
    int64 and anything else as f32: on the card through pinned host memory
    with a non-blocking copy (the caching host allocator keeps the pinned
    block until the copy is done)."""
    t = torch.as_tensor(x)
    integer = not (t.is_floating_point() or t.is_complex() or t.dtype == torch.bool)
    t = t.to(torch.int64 if integer else torch.float32)
    if device.type != "cuda" or t.is_cuda:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """{name: tensor or value} read back to the host without draining the
    stream: card tensors are copied into pinned host buffers, non-blocking,
    behind the work queued so far, with an event recorded after the copies;
    `get()` waits on that event alone and returns the host values (numpy
    arrays for tensors; the values as they are otherwise)."""

    def __init__(self, values: Mapping):
        self.values, self.event = {}, None
        for k, v in values.items():
            if isinstance(v, torch.Tensor):
                v = v.detach()
                if v.is_cuda:
                    host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    host.copy_(v, non_blocking=True)
                    self.event, v = torch.cuda.Event(), host
            self.values[k] = v
        if self.event is not None:
            self.event.record()

    def get(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return {k: v.numpy() if isinstance(v, torch.Tensor) else v
                for k, v in self.values.items()}


def stop_requested(stop, dp=None) -> bool:
    """Whether the run stops here: `stop.requested`, or under data
    parallelism that of any rank, latched on this one (every rank must call
    it at the same point)."""
    if dp is not None and dp.any(stop.requested):
        stop.requested = True
    return stop.requested


def train_one_epoch(state: TrainState, loss_fn: Callable, train_loader: Iterable[Mapping],
                    metrics: Mapping, epoch: int = 0, num_epochs: int = 1,
                    tracker=None, stop=None) -> dict:
    """train_loader yields {"image": (B, 3, H, W), "label": (B, 1, H, W)}
    numpy or torch batches, or a language model's {"tokens": (B, L)}; they
    are moved to the model's device. Returns the epoch's metric dict:
    "Train/mean <metric>" for each metric (none for a language model, which
    takes an empty `metrics`) and "Train/images_per_sec". Prints each step's
    loss and the epoch's metrics.

    `tracker` (a `ScalarTracker`) gets each step's scalars as "Train/<name>"
    at the step's count, and the epoch's metrics at the step count after
    the epoch. `stop` (a `GracefulShutdown`) is read before each step,
    before its batch is drawn: once it is requested the epoch ends there,
    and the caller checkpoints."""
    device, dp = next(state.model.parameters()).device, state.dp
    t0 = time.perf_counter()
    n_img = 0
    n_batches = len(train_loader) if hasattr(train_loader, "__len__") else "?"
    pending = None  # (batch index, step, scalars, stats) of the step before

    def flush(entry):
        i, step, scalars, stats = entry
        with span("train.copy_wait"):
            scalars, stats = scalars.get(), stats.get()
        with span("train.metrics"):
            if dp is not None:  # the global batch's losses and statistics
                scalars = dp.host_sum(scalars)
                if stats:
                    stats.update({k: dp.host_gather(stats[k])
                                  for k in ("inter", "psum", "tsum", "weight")})
            print(f"Epoch [{epoch + 1}/{num_epochs}] Training [{i + 1}/{n_batches}] "
                  f"Loss: {float(scalars['total_loss']):1.5f}", flush=True)
            if tracker is not None:
                tracker.log({f"Train/{k}": v.item() for k, v in scalars.items()}, step=step)
            if stats:
                for m in metrics.values():
                    m.update_stats(stats)

    batches = iter(train_loader)
    for i in itertools.count():
        if stop is not None and stop_requested(stop, dp):
            break  # preemption: stop at a step boundary; the caller checkpoints
        try:
            with span("train.data"):  # the loader's wait included
                batch = next(batches)
                keys = ("tokens",) if "tokens" in batch else ("image", "label")
                n_img += batch[keys[0]].shape[0]
                weight = None
                if dp is not None:
                    batch, weight = shard_batch({k: batch[k] for k in keys}, dp.rank, dp.world)
                    weight = stage(weight, device)
                staged = [stage(batch[k], device) for k in keys]
                images, labels = staged[0], staged[-1]
        except StopIteration:
            break
        with span("train.step"):
            step = state.step
            scalars, stats = train_step(state, images, labels, loss_fn, sample_weight=weight)
            entry = (i, step, HostCopy(scalars), HostCopy(stats))
        if pending is not None:
            flush(pending)
        pending = entry
    if pending is not None:
        flush(pending)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    metric = {}
    for name, m in metrics.items():
        # an epoch stopped before its first step has no statistics
        metric[f"Train/mean {name}"] = float(np.nanmean(m.aggregate())) if n_img else float("nan")
        m.reset()
    metric["Train/images_per_sec"] = n_img / max(dt, 1e-9)
    print(f"Epoch [{epoch + 1}/{num_epochs}] Training metric {metric}", flush=True)
    if tracker is not None:
        tracker.log(metric, step=state.step)
    return metric
