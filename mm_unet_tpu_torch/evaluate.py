"""Validation loop (counterpart of `train.py:87-116::val_one_epoch`):
sliding-window logits through the predictor, the loss on the logits, and
the metrics (`train/metrics.py`) of the prediction thresholded at
sigmoid > 0.5.

The metrics take their sufficient statistics from the card, as in
`train/loop.py`: `trainer.seg_stats` gives each batch's (B, C)
intersection, prediction sum and target sum, and each metric whose
`takes_stats` is true gets them through `update_stats`. The thresholded
masks and the labels are read back only for a metric that needs the masks
themselves (HD95, or any object without `takes_stats`), and only when the
metric dict holds one.

On the card one batch stays in flight, as in `train/loop.py`: each batch is
staged through pinned host memory (`stage`), and its loss and statistics
(and masks, where needed) are read back through `HostCopy` after the next
batch is issued, so the host waits on that copy's event alone. Each call's
phases are timed as the spans `eval.data`, `eval.forward`, `eval.copy_wait`
and `eval.metrics`, and the mask metrics' updates as `eval.masks` inside
`eval.metrics` (`utils/spans.py`)."""

from __future__ import annotations

import itertools
from typing import Callable, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from mm_unet_tpu_torch.train.loop import HostCopy, stage
from mm_unet_tpu_torch.train.predictor import make_predictor
from mm_unet_tpu_torch.train.trainer import seg_stats
from mm_unet_tpu_torch.utils.spans import span


def val_one_epoch(model: nn.Module, loss_fn: Callable, inferer: Callable,
                  val_loader: Iterable[Mapping], metrics: Mapping, epoch: int = 0,
                  num_epochs: int = 1, step: int = 0, tracker=None,
                  class_names: Optional[Sequence[str]] = None):
    """val_loader yields {"image": (B, 3, H, W), "label": (B, 1, H, W)}
    numpy or torch batches; they are moved to the model's device. loss_fn
    has `trainer.make_loss_fn`'s form, logits, labels -> (total, losses).
    metrics is a dict of metric objects with aggregate() and reset(). One
    whose `takes_stats` is true gets `seg_stats`' (B, C) counts through
    update_stats(stats); any other is called as __call__(y_pred, y) on the
    thresholded masks and the labels, which are read back to the host only
    then. Prints each batch's loss and the epoch's metrics; `tracker`
    gets "Val/total_loss" at `step`, `step` + 1, ... and the metrics at the
    step after the last batch. With `class_names` (one per output channel,
    the EDD set's five) each metric also reports "Val/<class> <metric>".
    Returns (mean f1, metric dict, per-batch losses)."""
    device = next(model.parameters()).device
    predictor = make_predictor(model)
    n_batches = len(val_loader) if hasattr(val_loader, "__len__") else "?"
    takes_stats = [m for m in metrics.values() if getattr(m, "takes_stats", False)]
    takes_masks = [m for m in metrics.values() if not getattr(m, "takes_stats", False)]
    losses = []
    pending = None  # (batch index, HostCopy) of the batch before

    def flush(entry):
        nonlocal step
        i, copy = entry
        with span("eval.copy_wait"):
            host = copy.get()
        with span("eval.metrics"):
            losses.append(float(host["loss"]))
            for m in takes_stats:
                m.update_stats(host)
            if takes_masks:
                with span("eval.masks"):
                    for m in takes_masks:
                        m(y_pred=host["preds"], y=host["labels"])
            print(f"Epoch [{epoch + 1}/{num_epochs}] Validation [{i + 1}/{n_batches}] "
                  f"Loss: {losses[-1]:1.5f}", flush=True)
            if tracker is not None:
                tracker.log({"Val/total_loss": losses[-1]}, step=step)
            step += 1

    batches = iter(val_loader)
    for i in itertools.count():
        try:
            with span("eval.data"):  # the loader's wait included
                batch = next(batches)
                images, labels = stage(batch["image"], device), stage(batch["label"], device)
        except StopIteration:
            break
        with span("eval.forward"):
            logits = inferer(images, predictor)
            total, _ = loss_fn(logits, labels)
            values = {"loss": total, **seg_stats(logits, labels)}
            if takes_masks:
                values.update(preds=(torch.sigmoid(logits) > 0.5).float(), labels=labels)
            entry = (i, HostCopy(values))
        if pending is not None:
            flush(pending)
        pending = entry
    if pending is not None:
        flush(pending)
    metric = {}
    for name, m in metrics.items():
        agg = m.aggregate()
        m.reset()
        metric[f"Val/mean {name}"] = float(np.nanmean(agg))
        if class_names is not None and np.size(agg) == len(class_names):
            for cls, v in zip(class_names, np.ravel(agg)):
                metric[f"Val/{cls} {name}"] = float(v)
    print(f"Epoch [{epoch + 1}/{num_epochs}] Validation metric {metric}", flush=True)
    if tracker is not None:
        tracker.log(metric, step=step)
    return metric.get("Val/mean f1"), metric, losses
