"""The training epoch (counterpart of `train.py:32-84::train_one_epoch`).

Each batch goes through `train_step`; the metric statistics feed the numpy
metrics' `update_stats` (`train/metrics.py`). The host reads a step's loss and statistics
only after the next step has been issued, so it never waits for the card
between steps. The running step is the train state's `step`. The mesh and
batch sharding of the JAX loop are not ported (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

from mm_unet_tpu_torch.train.trainer import TrainState, train_step


def _to_host(stats: dict) -> dict:
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in stats.items()}


def train_one_epoch(state: TrainState, loss_fn: Callable, train_loader: Iterable[Mapping],
                    metrics: Mapping, epoch: int = 0, num_epochs: int = 1,
                    tracker=None, stop=None) -> dict:
    """train_loader yields {"image": (B, 3, H, W), "label": (B, 1, H, W)}
    numpy or torch batches; they are moved to the model's device. Returns
    the epoch's metric dict: "Train/mean <metric>" for each metric and
    "Train/images_per_sec". Prints each step's loss and the epoch's metrics.

    `tracker` (a `ScalarTracker`) gets each step's scalars as "Train/<name>"
    at the step's count, and the epoch's metrics at the step count after
    the epoch. `stop` (a `GracefulShutdown`) is read before each step: once
    it is requested the epoch ends there, and the caller checkpoints."""
    device = next(state.model.parameters()).device
    t0 = time.perf_counter()
    n_img = 0
    n_batches = len(train_loader) if hasattr(train_loader, "__len__") else "?"
    pending = None  # (batch index, step, scalars, stats) of the step before

    def flush(entry):
        i, step, scalars, stats = entry
        print(f"Epoch [{epoch + 1}/{num_epochs}] Training [{i + 1}/{n_batches}] "
              f"Loss: {float(scalars['total_loss']):1.5f}", flush=True)
        if tracker is not None:
            tracker.log({f"Train/{k}": v.item() for k, v in scalars.items()}, step=step)
        host = _to_host(stats)
        for m in metrics.values():
            m.update_stats(host)

    for i, batch in enumerate(train_loader):
        if stop is not None and stop.requested:
            break  # preemption: stop at a step boundary; the caller checkpoints
        images = torch.as_tensor(batch["image"], dtype=torch.float32, device=device)
        labels = torch.as_tensor(batch["label"], dtype=torch.float32, device=device)
        step = state.step
        scalars, stats = train_step(state, images, labels, loss_fn)
        n_img += images.shape[0]
        if pending is not None:
            flush(pending)
        pending = (i, step, scalars, stats)
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
