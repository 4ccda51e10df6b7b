"""DiceFocal loss, forward (counterpart of
`mm_unet_tpu/train/losses.py::dice_focal_loss`, MONAI semantics: sigmoid
Dice per (sample, channel) plus the sigmoid focal loss, mean reduction)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _mean_per_sample(v: torch.Tensor) -> torch.Tensor:
    if v.ndim > 1:
        v = v.mean(dim=tuple(range(1, v.ndim)))
    return v.mean()


def dice_loss(logits, targets, smooth_nr: float = 0.0, smooth_dr: float = 1e-5):
    p = torch.sigmoid(logits)
    t = targets.to(p.dtype)
    dims = tuple(range(2, p.ndim))
    inter = (p * t).sum(dims)
    denom = p.sum(dims) + t.sum(dims)
    return _mean_per_sample(1.0 - (2.0 * inter + smooth_nr) / (denom + smooth_dr))


def focal_loss(logits, targets, gamma: float = 2.0):
    t = targets.to(logits.dtype)
    ce = F.binary_cross_entropy_with_logits(logits, t, reduction="none")
    p = torch.sigmoid(logits)
    p_t = p * t + (1 - p) * (1 - t)
    return _mean_per_sample(ce * (1 - p_t) ** gamma)


def dice_focal_loss(logits: torch.Tensor, targets: torch.Tensor, smooth_nr: float = 0.0,
                    smooth_dr: float = 1e-5, gamma: float = 2.0, lambda_dice: float = 1.0,
                    lambda_focal: float = 1.0) -> torch.Tensor:
    """logits, targets: (B, C, H, W). Returns a scalar."""
    return (lambda_dice * dice_loss(logits, targets, smooth_nr, smooth_dr)
            + lambda_focal * focal_loss(logits, targets, gamma))
