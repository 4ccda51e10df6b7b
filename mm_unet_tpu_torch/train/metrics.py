"""Segmentation metrics (counterpart of `mm_unet_tpu/train/metrics.py`,
MONAI semantics): Dice (NaN-aware mean over samples, per channel), mean
IoU, and f1 / precision / recall / MCC / accuracy from confusion counts
summed over the epoch. Numpy only.

Every metric keeps per-(sample, channel) sufficient statistics: the
intersection, prediction sum and target sum of binary masks, and the pixel
count per plane. `update(y_pred, y)` computes them from thresholded
(B, C, H, W) masks; `update_stats` takes them as `trainer.seg_stats`
returns them (a `weight` of 0 drops a sample). Every channel counts: the
training and validation loops keep the background
(`include_background=True` in the JAX package).
"""

from __future__ import annotations

import numpy as np


def mask_stats(y_pred, y) -> dict:
    p = np.asarray(y_pred, np.float64)
    t = np.asarray(y, np.float64)
    dims = tuple(range(2, p.ndim))
    return {"inter": (p * t).sum(dims), "psum": p.sum(dims), "tsum": t.sum(dims),
            "npix": int(np.prod(p.shape[2:]))}


def _div(num, den):
    """num / den, NaN where den is 0 (MONAI's 0/0)."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(den != 0, num / np.where(den != 0, den, 1.0), np.nan)


class Metric:
    def __init__(self):
        self.reset()

    def reset(self):
        self.rows: list[tuple] = []  # (inter, psum, tsum, npix), each (B, C)

    def update(self, y_pred, y):
        self.update_stats(mask_stats(y_pred, y))

    __call__ = update

    def update_stats(self, stats: dict):
        inter, psum, tsum = (np.asarray(stats[k], np.float64) for k in ("inter", "psum", "tsum"))
        if stats.get("weight") is not None:  # drop padded samples
            keep = np.asarray(stats["weight"]) > 0
            inter, psum, tsum = inter[keep], psum[keep], tsum[keep]
        self.rows.append((inter, psum, tsum, stats["npix"]))

    def _cat(self):
        return [np.concatenate([r[i] for r in self.rows]) for i in range(3)]


class DiceMetric(Metric):
    def aggregate(self) -> np.ndarray:
        inter, psum, tsum = self._cat()
        with np.errstate(invalid="ignore"):
            return np.nanmean(_div(2 * inter, psum + tsum), axis=0)  # (C,)


class MeanIoU(Metric):
    def aggregate(self) -> np.ndarray:
        inter, psum, tsum = self._cat()
        with np.errstate(invalid="ignore"):
            return np.asarray([np.nanmean(_div(inter, psum + tsum - inter).mean(axis=1))])


class ConfusionMatrixMetric(Metric):
    METRICS = ("f1 score", "precision", "recall", "accuracy",
               "matthews correlation coefficient")

    def __init__(self, metric_name: str):
        if metric_name not in self.METRICS:
            raise ValueError(metric_name)
        self.metric_name = metric_name
        super().__init__()

    def aggregate(self) -> np.ndarray:
        tp = sum(i.sum(0) for i, _, _, _ in self.rows)
        fp = sum((p - i).sum(0) for i, p, _, _ in self.rows)
        fn = sum((t - i).sum(0) for i, _, t, _ in self.rows)
        tn = sum((n - p - t + i).sum(0) for i, p, t, n in self.rows)
        name = self.metric_name
        if name == "f1 score":
            v = _div(2 * tp, 2 * tp + fp + fn)
        elif name == "precision":
            v = _div(tp, tp + fp)
        elif name == "recall":
            v = _div(tp, tp + fn)
        elif name == "accuracy":
            v = _div(tp + tn, tp + tn + fp + fn)
        else:
            v = _div(tp * tn - fp * fn, np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return np.atleast_1d(v)


def build_metrics() -> dict[str, Metric]:
    """The seven metrics of the training and validation loops."""
    return {
        "dice_metric": DiceMetric(),
        "miou_metric": MeanIoU(),
        "f1": ConfusionMatrixMetric("f1 score"),
        "precision": ConfusionMatrixMetric("precision"),
        "recall": ConfusionMatrixMetric("recall"),
        "MCC": ConfusionMatrixMetric("matthews correlation coefficient"),
        "ACC": ConfusionMatrixMetric("accuracy"),
    }
