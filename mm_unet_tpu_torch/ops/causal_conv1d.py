"""Causal depthwise 1-D convolution, plain PyTorch (counterpart of
`mm_unet_tpu/ops/causal_conv1d.py::causal_conv1d`): f32 accumulation, the
result cast back to the input dtype."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def causal_conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """x (B, D, L), weight (D, W), bias (D,) -> (B, D, L) in x's dtype.

    Tap j multiplies x[t - (W-1-j)]; `reverse` is the anti-causal variant
    (x[t + (W-1-j)]), equal to flip(causal_conv1d(flip(x)))."""
    if activation not in (None, "silu", "swish"):
        raise NotImplementedError(f"activation {activation}")
    xf, wf = x.float(), weight.float()
    length, width = xf.shape[-1], wf.shape[1]
    out = xf * wf[None, :, -1:]
    for j in range(width - 1):
        shift = width - 1 - j
        if shift >= length:
            continue  # every tap falls into the zero padding
        if reverse:
            xs = F.pad(xf[:, :, shift:], (0, shift))
        else:
            xs = F.pad(xf[:, :, : length - shift], (shift, 0))
        out = out + xs * wf[None, :, j : j + 1]
    if bias is not None:
        out = out + bias.float()[None, :, None]
    if activation is not None:
        out = F.silu(out)
    return out.to(x.dtype)
