"""The training epoch (counterpart of `train.py:32-84::train_one_epoch`).

Each batch goes through `train_step`; the metric statistics feed the numpy
metrics' `update_stats` (`train/metrics.py`). The host reads a step's loss and statistics
only after the next step has been issued, so it never waits for the card
between steps. The mesh and batch sharding, the scalar tracker and
preemption handling of the JAX loop are not ported (ROADMAP.md).
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
                    metrics: Mapping, epoch: int = 0, num_epochs: int = 1) -> dict:
    """train_loader yields {"image": (B, 3, H, W), "label": (B, 1, H, W)}
    numpy or torch batches; they are moved to the model's device. Returns
    the epoch's metric dict: "Train/mean <metric>" for each metric and
    "Train/images_per_sec". Prints each step's loss and the epoch's metrics."""
    device = next(state.model.parameters()).device
    t0 = time.perf_counter()
    n_img = 0
    pending = None  # (batch index, scalars, stats) of the step before

    def flush(entry):
        i, scalars, stats = entry
        print(f"Epoch [{epoch + 1}/{num_epochs}] Training [{i + 1}] "
              f"Loss: {float(scalars['total_loss']):1.5f}", flush=True)
        host = _to_host(stats)
        for m in metrics.values():
            m.update_stats(host)

    for i, batch in enumerate(train_loader):
        images = torch.as_tensor(batch["image"], dtype=torch.float32, device=device)
        labels = torch.as_tensor(batch["label"], dtype=torch.float32, device=device)
        scalars, stats = train_step(state, images, labels, loss_fn)
        n_img += images.shape[0]
        if pending is not None:
            flush(pending)
        pending = (i, scalars, stats)
    if pending is not None:
        flush(pending)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    metric = {}
    for name, m in metrics.items():
        metric[f"Train/mean {name}"] = float(np.nanmean(m.aggregate()))
        m.reset()
    metric["Train/images_per_sec"] = n_img / max(dt, 1e-9)
    print(f"Epoch [{epoch + 1}/{num_epochs}] Training metric {metric}", flush=True)
    return metric
