"""Causal depthwise 1-D convolution and its single-token decode step, plain
PyTorch (counterparts of `mm_unet_tpu/ops/causal_conv1d.py::causal_conv1d`
and `::causal_conv1d_update`, which are plain JAX): f32 accumulation, the
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


def causal_conv1d_update(
    x: torch.Tensor,
    conv_state: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The single-token decode step (counterpart of
    `mm_unet_tpu/ops/causal_conv1d.py::causal_conv1d_update`): x (B, D) the
    current token, conv_state (B, D, W) the last W inputs, weight (D, W),
    bias (D,). Returns (out (B, D) in x's dtype, new_state (B, D, W)): the
    state rolled left by one with x written last, and the conv over it."""
    if activation not in (None, "silu", "swish"):
        raise NotImplementedError(f"activation {activation}")
    state = torch.cat([conv_state[..., 1:], x[..., None].to(conv_state.dtype)], dim=-1)
    out = (state.float() * weight.float()[None]).sum(-1)
    if bias is not None:
        out = out + bias.float()[None]
    if activation is not None:
        out = F.silu(out)
    return out.to(x.dtype), state
