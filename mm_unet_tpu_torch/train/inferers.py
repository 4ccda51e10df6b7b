"""Sliding-window inference with MONAI `SlidingWindowInferer` semantics
(counterpart of `mm_unet_tpu/train/inferers.py:116-212`): symmetric constant
padding up to the window, dense window starts at interval roi*(1-overlap),
windows batched through the predictor in groups of max(sw_batch_size, B),
and constant or gaussian blending."""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F


def _dense_starts(img: int, roi: int, interval: int) -> list[int]:
    """MONAI dense_patch_slices start positions along one dim."""
    if img <= roi:
        return [0]
    num = int(math.ceil((img - roi) / interval)) + 1
    return [min(i * interval, img - roi) for i in range(num)]


def _gaussian_importance(rh: int, rw: int, device, sigma_scale: float = 0.125) -> torch.Tensor:
    """MONAI BlendMode.GAUSSIAN importance map, (1, 1, rh, rw) f32."""
    def g(n):
        x = torch.arange(n, dtype=torch.float32, device=device) - (n - 1) / 2.0
        return torch.exp(-0.5 * (x / (n * sigma_scale)) ** 2)

    m = g(rh)[:, None] * g(rw)[None, :]
    return torch.clamp(m, min=float(m.max()) * 1e-3)[None, None]


def sliding_window_inference(
    inputs: torch.Tensor,
    roi_size: Sequence[int],
    predictor: Callable[[torch.Tensor], torch.Tensor],
    overlap: float = 0.5,
    sw_batch_size: int = 4,
    mode: str = "constant",
) -> torch.Tensor:
    """inputs (B, C, H, W); predictor maps (N, C, rh, rw) -> (N, K, rh, rw).
    Returns the stitched (B, K, H, W) logits."""
    b, c, h, w = inputs.shape
    rh, rw = roi_size
    pad_h, pad_w = max(rh - h, 0), max(rw - w, 0)
    if pad_h or pad_w:
        inputs = F.pad(inputs, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
    hp, wp = inputs.shape[2:]
    ih = max(int(rh * (1 - overlap)), 1)
    iw = max(int(rw * (1 - overlap)), 1)
    starts = [(y, x) for y in _dense_starts(hp, rh, ih) for x in _dense_starts(wp, rw, iw)]

    windows = torch.cat([inputs[:, :, y : y + rh, x : x + rw] for y, x in starts])
    total = windows.shape[0]
    group = min(max(sw_batch_size, b), total)
    outs = []
    for i in range(0, total, group):
        chunk = windows[i : i + group]
        n = chunk.shape[0]
        if n < group:  # pad the last group to the common group size
            chunk = torch.cat([chunk, chunk.new_zeros((group - n,) + chunk.shape[1:])])
        outs.append(predictor(chunk)[:n])
    preds = torch.cat(outs)  # (num_win * B, K, rh, rw)

    k = preds.shape[1]
    if mode == "gaussian":
        one = _gaussian_importance(rh, rw, preds.device).to(preds.dtype)
    elif mode == "constant":
        one = torch.ones(1, 1, rh, rw, dtype=preds.dtype, device=preds.device)
    else:
        raise ValueError(f"blend mode {mode!r}")
    canvas = preds.new_zeros(b, k, hp, wp)
    count = preds.new_zeros(1, 1, hp, wp)
    for idx, (y, x) in enumerate(starts):
        canvas[:, :, y : y + rh, x : x + rw] += preds[idx * b : (idx + 1) * b] * one
        count[:, :, y : y + rh, x : x + rw] += one
    out = canvas / count
    if pad_h or pad_w:
        out = out[:, :, pad_h // 2 : pad_h // 2 + h, pad_w // 2 : pad_w // 2 + w]
    return out


class SlidingWindowInferer:
    """Callable wrapper: `inferer(images, predictor)`."""

    def __init__(self, roi_size, overlap: float = 0.5, sw_batch_size: int = 4,
                 mode: str = "constant"):
        self.roi_size = tuple(roi_size)
        self.overlap = overlap
        self.sw_batch_size = sw_batch_size
        self.mode = mode

    def __call__(self, inputs: torch.Tensor, predictor) -> torch.Tensor:
        return sliding_window_inference(inputs, self.roi_size, predictor, self.overlap,
                                        self.sw_batch_size, self.mode)
