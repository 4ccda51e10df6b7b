"""Segmentation metrics (counterpart of `mm_unet_tpu/train/metrics.py`,
MONAI semantics): Dice (NaN-aware mean over samples, per channel), mean
IoU, f1 / precision / recall / MCC / accuracy from confusion counts
summed over the epoch, and the percentile Hausdorff distance (HD95, scipy).

Every metric but HD95 keeps per-(sample, channel) sufficient statistics:
the intersection, prediction sum and target sum of binary masks, and the
pixel count per plane. `update(y_pred, y)` computes them from thresholded
(B, C, H, W) masks; `update_stats` takes them as `trainer.seg_stats`
returns them (a `weight` of 0 drops a sample). `include_background=False`
drops channel 0 when there is more than one channel, as MONAI does (the JAX
package's `update` drops it from a single channel too, leaving nothing);
the loops keep it (`build_metrics(include_background=True)`).
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
    takes_stats = True  # fed by `update_stats`; False: it needs the masks themselves

    def __init__(self, include_background: bool = True):
        self.include_background = include_background
        self.reset()

    def reset(self):
        self.rows: list[tuple] = []  # (inter, psum, tsum, npix), each (B, C)

    def update(self, y_pred, y):
        self.update_stats(mask_stats(y_pred, y))

    def __call__(self, y_pred, y):
        self.update(y_pred, y)

    def update_stats(self, stats: dict):
        inter, psum, tsum = (np.asarray(stats[k], np.float64) for k in ("inter", "psum", "tsum"))
        if stats.get("weight") is not None:  # drop padded samples
            keep = np.asarray(stats["weight"]) > 0
            inter, psum, tsum = inter[keep], psum[keep], tsum[keep]
        if not self.include_background and inter.shape[1] > 1:
            inter, psum, tsum = inter[:, 1:], psum[:, 1:], tsum[:, 1:]
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

    def __init__(self, metric_name: str, include_background: bool = True):
        if metric_name not in self.METRICS:
            raise ValueError(metric_name)
        self.metric_name = metric_name
        super().__init__(include_background)

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


class HausdorffDistanceMetric(Metric):
    """Symmetric percentile Hausdorff distance between the surfaces of
    binary masks, one value per (sample, channel), NaN where either mask is
    empty; `aggregate` is the NaN-aware mean. Fed by `update` only."""

    takes_stats = False

    def __init__(self, include_background: bool = True, percentile: float = 95.0):
        self.percentile = percentile
        super().__init__(include_background)

    def reset(self):
        self.vals: list[float] = []

    def update_stats(self, stats: dict):
        raise NotImplementedError("HD95 needs the masks: call update(y_pred, y)")

    @staticmethod
    def _surface_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Distances from each surface pixel of a to the surface of b."""
        from scipy import ndimage

        if not a.any() or not b.any():
            return np.array([np.nan])
        surface_a = a & ~ndimage.binary_erosion(a)
        dt_b = ndimage.distance_transform_edt(~(b & ~ndimage.binary_erosion(b)))
        return dt_b[surface_a]

    def update(self, y_pred, y):
        p = np.asarray(y_pred).astype(bool)
        t = np.asarray(y).astype(bool)
        if not self.include_background and p.shape[1] > 1:
            p, t = p[:, 1:], t[:, 1:]
        for n in range(p.shape[0]):
            for c in range(p.shape[1]):
                d = np.concatenate([self._surface_distances(p[n, c], t[n, c]),
                                    self._surface_distances(t[n, c], p[n, c])])
                self.vals.append(float(np.percentile(d, self.percentile))
                                 if np.isfinite(d).all() else np.nan)

    def aggregate(self) -> np.ndarray:
        with np.errstate(invalid="ignore"):
            return np.asarray([np.nanmean(self.vals)])


def build_metrics(include_background: bool = True) -> dict[str, Metric]:
    """The seven metrics of the training and validation loops."""
    ib = include_background
    return {
        "dice_metric": DiceMetric(ib),
        "miou_metric": MeanIoU(ib),
        "f1": ConfusionMatrixMetric("f1 score", ib),
        "precision": ConfusionMatrixMetric("precision", ib),
        "recall": ConfusionMatrixMetric("recall", ib),
        "MCC": ConfusionMatrixMetric("matthews correlation coefficient", ib),
        "ACC": ConfusionMatrixMetric("accuracy", ib),
    }
