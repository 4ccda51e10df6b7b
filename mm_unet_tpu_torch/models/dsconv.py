"""Dynamic-snake deformable conv, DSConv (counterpart of
`mm_unet_tpu/models/dsconv.py`): the non-Mamba predecessor of MMConv,
used throughout UM_Net. offset conv 3x3 -> GroupNorm(k) -> tanh, then one
of two morphologies, then GroupNorm(out/4):

- morph 0: row coordinates deform (cumulative offsets from the kernel
  centre), tap j reads column clamp(w + j - k//2); the row sample and the
  (k,1) stride-(k,1) conv run as one `tap_conv` (kernels 3/4 on the card),
  as MMConv's does. The JAX module's choice between a 2-hot matmul and a
  row gather (`layers.py::deform_sample`) computes this same function.
- morph 1: column coordinates deform, rows spread by the tap offset;
  bilinear grid sampling (zeros padding, align_corners=True) of a
  (B, H, W*K) map, taps consecutive per column, then the (1,k)
  stride-(1,k) conv `dsc_conv_y`.

NCHW in and out. Parameter names are the torch reference's
(`mm_unet_tpu.utils.torch_convert.dsconv_pairs`): offset_conv, gn_offset,
dsc_conv_x (morph 0) or dsc_conv_y (morph 1), gn.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mm_unet_tpu_torch.models.layers import (
    Conv2d,
    GroupNorm,
    grid_sample_conv,
    nchw_to_nhwc,
    row_sample_conv,
)
from mm_unet_tpu_torch.ops.geometry import accumulate_offsets_from_center_last


class DSConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 9,
                 extend_scope: float = 1.0, morph: int = 0):
        super().__init__()
        if morph not in (0, 1):
            raise ValueError("morph should be 0 or 1.")
        k = self.kernel_size = kernel_size
        self.extend_scope, self.morph = extend_scope, morph
        self.offset_conv = Conv2d(in_channels, 2 * k, 3, padding=1)
        self.gn_offset = GroupNorm(k, 2 * k)
        if morph == 0:
            self.dsc_conv_x = Conv2d(in_channels, out_channels, (k, 1), stride=(k, 1))
        else:
            self.dsc_conv_y = Conv2d(in_channels, out_channels, (1, k), stride=(1, k))
        self.gn = GroupNorm(out_channels // 4, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        k = self.kernel_size
        offset = nchw_to_nhwc(torch.tanh(self.gn_offset(self.offset_conv(x))))
        dev = x.device
        rows = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
        if self.morph == 0:
            acc = accumulate_offsets_from_center_last(offset[..., :k].float())
            return self._sample_conv(nchw_to_nhwc(x), rows + acc * self.extend_scope)
        cols = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None]
        spread = torch.linspace(-(k // 2), k // 2, k, device=dev)[None, None, None, :]
        acc = accumulate_offsets_from_center_last(offset[..., k:].float())
        x_new = cols + acc * self.extend_scope
        y_new = (rows + spread).expand_as(x_new)
        return grid_sample_conv(nchw_to_nhwc(x), y_new.reshape(b, h, w * k),
                                x_new.reshape(b, h, w * k), self.dsc_conv_y, self.gn)

    def _sample_conv(self, feat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return row_sample_conv(feat, y, self.dsc_conv_x, self.gn)
