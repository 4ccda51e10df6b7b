"""DiceFocal loss (counterpart of `mm_unet_tpu/train/losses.py::dice_focal_loss`,
MONAI semantics: sigmoid Dice per (sample, channel) plus the sigmoid focal
loss, mean reduction, optionally weighted per sample)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _wmean(per_sample: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of per-sample values (B, ...); with `weight` (B,), the
    weight-averaged mean sum(v * w) / max(sum(w), 1) (rows of weight 0, such
    as batch padding, count for nothing)."""
    if per_sample.ndim > 1:
        per_sample = per_sample.mean(dim=tuple(range(1, per_sample.ndim)))
    if weight is None:
        return per_sample.mean()
    w = weight.to(per_sample.dtype)
    return (per_sample * w).sum() / torch.clamp(w.sum(), min=1.0)


def dice_loss(logits, targets, smooth_nr: float = 0.0, smooth_dr: float = 1e-5,
              weight: Optional[torch.Tensor] = None):
    p = torch.sigmoid(logits)
    t = targets.to(p.dtype)
    dims = tuple(range(2, p.ndim))
    inter = (p * t).sum(dims)
    denom = p.sum(dims) + t.sum(dims)
    return _wmean(1.0 - (2.0 * inter + smooth_nr) / (denom + smooth_dr), weight)


def focal_loss(logits, targets, gamma: float = 2.0, weight: Optional[torch.Tensor] = None):
    t = targets.to(logits.dtype)
    ce = F.binary_cross_entropy_with_logits(logits, t, reduction="none")
    p = torch.sigmoid(logits)
    p_t = p * t + (1 - p) * (1 - t)
    return _wmean(ce * (1 - p_t) ** gamma, weight)


def dice_focal_loss(logits: torch.Tensor, targets: torch.Tensor, smooth_nr: float = 0.0,
                    smooth_dr: float = 1e-5, gamma: float = 2.0, lambda_dice: float = 1.0,
                    lambda_focal: float = 1.0,
                    weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits, targets: (B, C, H, W); weight: (B,) or None. Returns a scalar."""
    return (lambda_dice * dice_loss(logits, targets, smooth_nr, smooth_dr, weight)
            + lambda_focal * focal_loss(logits, targets, gamma, weight))


# the losses `train.trainer.make_loss_fn` can name (the JAX package's
# LOSS_REGISTRY; its other entries are queued in ROADMAP.md)
LOSS_REGISTRY = {"dice_focal_loss": dice_focal_loss}
