"""The serving predictor (counterpart of `mm_unet_tpu/train/trainer.py:176-216`,
`Predictor` and `make_predictor`)."""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn as nn


class Predictor:
    """Callable (N, C, H, W) -> logits, running `model` in eval mode under
    `torch.inference_mode()`. With `cast_dtype` (e.g. torch.bfloat16) it
    holds a copy of the model whose floating parameters and buffers are cast
    to it, casts the windows on the way in and returns f32 logits."""

    def __init__(self, model: nn.Module, cast_dtype: Optional[torch.dtype] = None):
        if cast_dtype is not None:
            model = copy.deepcopy(model).to(cast_dtype)
        self.model = model.eval()
        self.cast_dtype = cast_dtype

    def __call__(self, windows: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if self.cast_dtype is not None:
                return self.model(windows.to(self.cast_dtype)).float()
            return self.model(windows)


def make_predictor(model: nn.Module, dtype: Optional[torch.dtype] = None) -> Predictor:
    """dtype=torch.bfloat16 -> reduced-precision inference (see Predictor)."""
    return Predictor(model, cast_dtype=dtype)
