"""Segmentation losses (counterpart of `mm_unet_tpu/train/losses.py`), MONAI
semantics: DiceFocal (the reference's training loss), Dice, focal,
Tversky, generalized Dice and the DICE+BCE of the reference's mini
pipeline (with its `DICE_BCE_Loss` name and its `dice_coeff`). Each takes NCHW logits and binary targets of the same shape and
an optional per-sample `weight` (B,), and returns a scalar (mean over the
samples, weight-averaged when `weight` is given). Beside them, outside the
JAX package's registry, a language model's `next_token_loss`
(`TOKEN_LOSSES`)."""

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


def dice_loss(logits, targets, sigmoid: bool = True, smooth_nr: float = 0.0,
              smooth_dr: float = 1e-5, squared_pred: bool = False,
              weight: Optional[torch.Tensor] = None):
    """MONAI DiceLoss: 1 - Dice per (sample, channel) over the spatial dims."""
    p = torch.sigmoid(logits) if sigmoid else logits
    t = targets.to(p.dtype)
    dims = tuple(range(2, p.ndim))
    inter = (p * t).sum(dims)
    if squared_pred:
        denom = (p * p).sum(dims) + (t * t).sum(dims)
    else:
        denom = p.sum(dims) + t.sum(dims)
    return _wmean(1.0 - (2.0 * inter + smooth_nr) / (denom + smooth_dr), weight)


def focal_loss(logits, targets, gamma: float = 2.0, alpha: Optional[float] = None,
               weight: Optional[torch.Tensor] = None):
    """MONAI FocalLoss, sigmoid form: BCE * (1 - p_t)^gamma, times alpha for
    the positives and 1 - alpha for the negatives when `alpha` is given."""
    t = targets.to(logits.dtype)
    ce = F.binary_cross_entropy_with_logits(logits, t, reduction="none")
    p = torch.sigmoid(logits)
    p_t = p * t + (1 - p) * (1 - t)
    loss = ce * (1 - p_t) ** gamma
    if alpha is not None:
        loss = loss * (alpha * t + (1 - alpha) * (1 - t))
    return _wmean(loss, weight)


def dice_focal_loss(logits: torch.Tensor, targets: torch.Tensor, smooth_nr: float = 0.0,
                    smooth_dr: float = 1e-5, gamma: float = 2.0, lambda_dice: float = 1.0,
                    lambda_focal: float = 1.0,
                    weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's training loss; logits, targets: (B, C, H, W)."""
    return (lambda_dice * dice_loss(logits, targets, smooth_nr=smooth_nr, smooth_dr=smooth_dr,
                                    weight=weight)
            + lambda_focal * focal_loss(logits, targets, gamma=gamma, weight=weight))


def tversky_loss(logits, targets, alpha: float = 0.7, beta: float = 0.3,
                 smooth_nr: float = 1e-5, smooth_dr: float = 1e-5,
                 weight: Optional[torch.Tensor] = None):
    """MONAI TverskyLoss (sigmoid): 1 - (TP + s) / (TP + alpha FN + beta FP
    + s) per (sample, channel)."""
    p = torch.sigmoid(logits)
    t = targets.to(p.dtype)
    dims = tuple(range(2, p.ndim))
    tp = (p * t).sum(dims)
    fp = (p * (1 - t)).sum(dims)
    fn = ((1 - p) * t).sum(dims)
    return _wmean(1.0 - (tp + smooth_nr) / (tp + alpha * fn + beta * fp + smooth_dr), weight)


def generalized_dice_loss(logits, targets, w_type: str = "square", smooth_nr: float = 1e-5,
                          smooth_dr: float = 1e-5, weight: Optional[torch.Tensor] = None):
    """MONAI GeneralizedDiceLoss (sigmoid): per sample, the channels weighted
    by 1 / (target volume)^2 ("square"), 1 / volume ("simple") or 1
    ("uniform"), the volume floored at 1e-10."""
    p = torch.sigmoid(logits)
    t = targets.to(p.dtype)
    dims = tuple(range(2, p.ndim))
    ground = t.sum(dims)
    if w_type == "square":
        w = 1.0 / torch.clamp(ground * ground, min=1e-10)
    elif w_type == "simple":
        w = 1.0 / torch.clamp(ground, min=1e-10)
    else:
        w = torch.ones_like(ground)
    inter = (p * t).sum(dims)
    denom = p.sum(dims) + ground
    numer = 2.0 * (w * inter).sum(-1) + smooth_nr
    return _wmean(1.0 - numer / ((w * denom).sum(-1) + smooth_dr), weight)


def dice_bce_loss(logits, targets, smooth: float = 1e-5,
                  weight: Optional[torch.Tensor] = None):
    """DICE+BCE of the reference's mini pipeline (`loss.py`): the mean BCE
    plus one Dice over the whole batch; with `weight`, the BCE is
    weight-averaged and each sample's probabilities and targets are scaled
    by its weight before the Dice sums."""
    t = targets.to(logits.dtype)
    bce = _wmean(F.binary_cross_entropy_with_logits(logits, t, reduction="none"), weight)
    p = torch.sigmoid(logits)
    if weight is not None:
        wb = weight.to(p.dtype).reshape((-1,) + (1,) * (p.ndim - 1))
        p, t = p * wb, t * wb
    return bce + 1 - (2 * (p * t).sum() + smooth) / (p.sum() + t.sum() + smooth)


# the name the reference's mini pipeline gives it (its top-level `loss.py`)
DICE_BCE_Loss = dice_bce_loss  # noqa: N816


def dice_coeff(pred: torch.Tensor, target: torch.Tensor, smooth: float = 1e-5) -> torch.Tensor:
    """The mini pipeline's Dice coefficient (the root `loss.py`): one
    (2 sum(pred target) + smooth) / (sum(pred) + sum(target) + smooth) over
    every element of the batch, on probabilities or masks as given."""
    inter = (pred * target).sum()
    return (2.0 * inter + smooth) / (pred.sum() + target.sum() + smooth)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy of logits (B, L, V) at positions 0..L-2 against the
    next tokens, tokens (B, L) at 1..L-1: the mean over every predicted
    token; with `weight` (B,), each sequence's mean weight-averaged
    (`_wmean`)."""
    pred, target = logits[:, :-1].flatten(0, 1), tokens[:, 1:].flatten()
    if weight is None:
        return F.cross_entropy(pred, target)
    ce = F.cross_entropy(pred, target, reduction="none").view(tokens.shape[0], -1)
    return _wmean(ce, weight)


# the language models' losses, which the JAX package's registry lacks
TOKEN_LOSSES = {"next_token_loss": next_token_loss}

# the losses `train.trainer.make_loss_fn` can name, besides TOKEN_LOSSES:
# the JAX package's LOSS_REGISTRY, under its names
LOSS_REGISTRY = {
    "dice_focal_loss": dice_focal_loss,
    "dice_loss": dice_loss,
    "focal_loss": focal_loss,
    "focal_tversky": tversky_loss,
    "generalized_dice": generalized_dice_loss,
    "dice_bce": dice_bce_loss,
}
