"""Validation loop (counterpart of `train.py:87-116::val_one_epoch`):
sliding-window logits through the predictor, the loss on the logits, and
the numpy metrics (`train/metrics.py`) on the prediction thresholded at
sigmoid > 0.5."""

from __future__ import annotations

from typing import Callable, Iterable, Mapping

import numpy as np
import torch
import torch.nn as nn

from mm_unet_tpu_torch.train.predictor import make_predictor


def val_one_epoch(model: nn.Module, loss_fn: Callable, inferer: Callable,
                  val_loader: Iterable[Mapping], metrics: Mapping):
    """val_loader yields {"image": (B, 3, H, W), "label": (B, 1, H, W)}
    numpy or torch batches; they are moved to the model's device. metrics
    is a dict of metric objects with __call__(y_pred, y) and aggregate().
    Returns (mean f1, metric dict, per-batch losses)."""
    device = next(model.parameters()).device
    predictor = make_predictor(model)
    losses = []
    for batch in val_loader:
        images = torch.as_tensor(batch["image"], dtype=torch.float32, device=device)
        labels = torch.as_tensor(batch["label"], dtype=torch.float32, device=device)
        logits = inferer(images, predictor)
        losses.append(float(loss_fn(logits, labels)))
        preds = (torch.sigmoid(logits) > 0.5).float().cpu().numpy()
        labels_np = labels.cpu().numpy()
        for m in metrics.values():
            m(y_pred=preds, y=labels_np)
    metric = {}
    for name, m in metrics.items():
        agg = m.aggregate()
        m.reset()
        metric[f"Val/mean {name}"] = float(np.nanmean(agg))
    return metric.get("Val/mean f1"), metric, losses
