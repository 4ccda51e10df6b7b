"""ConvUNeXt in PyTorch (counterpart of `mm_unet_tpu/models/convunext.py`):
a ConvNeXt-style UNet, 7x7 reflect-padded depthwise convs, BatchNorm,
channel-last Linear expansions, and gated skip fusion in the ups.

The GELU is the exact (erf) one, as the reference's `nn.GELU()`; the JAX
module calls flax's `nn.gelu`, whose default is the tanh form
(ROADMAP.md, queue 3). `.eval()` is the JAX model's `train=False`;
`.train()` normalises with the batch statistics. Module and parameter
names are the torch reference's (`src/ConvUneXt/ConvNeXt.py`), as
`mm_unet_tpu.utils.torch_convert.convunext_pairs` tabulates them
(in_conv.0, in_conv.3.dwconv, down3.4.pwconv1, up1.gate, up1.conv1x1,
up1.conv.0.norm2, out_conv.0), so `utils.convert` maps JAX variables onto
this model.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    Linear,
    init_flax_style,
    nchw_to_nhwc,
    nhwc_to_nchw,
    resize_bilinear_align_corners,
)
from mm_unet_tpu_torch.models.unet import pad_to


def _reflect_pad(x: torch.Tensor, p: int = 3) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


class ConvNeXtBlock(nn.Module):
    """7x7 depthwise conv, BatchNorm, Linear 4x, GELU, Linear back,
    BatchNorm, then GELU of the sum with the input."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, groups=dim)
        self.norm1 = BatchNorm2d(dim)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.norm2 = BatchNorm2d(dim)

    def forward(self, x):
        h = nchw_to_nhwc(self.norm1(self.dwconv(_reflect_pad(x))))
        h = nhwc_to_nchw(self.pwconv2(F.gelu(self.pwconv1(h))))
        return F.gelu(x + self.norm2(h))


def _down(in_channels: int, out_channels: int, layer_num: int = 1) -> nn.Sequential:
    """BatchNorm, 2x2 stride-2 conv, then `layer_num` ConvNeXt blocks."""
    return nn.Sequential(BatchNorm2d(in_channels), Conv2d(in_channels, out_channels, 2, stride=2),
                         *[ConvNeXtBlock(out_channels) for _ in range(layer_num)])


class Up(nn.Module):
    """x1 normalised and upsampled x2, padded to the skip x2; the skip gated
    by x1 (g1, g2, g3 = gate(x1); x2 = sigmoid(linear1(g1 + x2)) x2 +
    sigmoid(g2) tanh(g3); linear2), then a 1x1 conv of [x2, x1] and a
    ConvNeXt block."""

    def __init__(self, in_channels: int, out_channels: int, bilinear: bool = True):
        super().__init__()
        c = in_channels // 2
        self.bilinear = bilinear
        self.norm = BatchNorm2d(c if bilinear else in_channels)
        if not bilinear:
            self.up = ConvTranspose2d(in_channels, c, 2, stride=2)
        self.gate = Linear(c, 3 * c)
        self.linear1 = Linear(c, c)
        self.linear2 = Linear(c, c)
        self.conv1x1 = Conv2d(2 * c, out_channels, 1)
        self.conv = nn.Sequential(ConvNeXtBlock(out_channels))

    def _fuse(self, x1, x2):  # channel-last
        g1, g2, g3 = self.gate(x1).chunk(3, dim=-1)
        x2 = torch.sigmoid(self.linear1(g1 + x2)) * x2 + torch.sigmoid(g2) * torch.tanh(g3)
        return self.linear2(x2)

    def forward(self, x1, x2):
        x1 = self.norm(x1)
        if self.bilinear:
            x1 = resize_bilinear_align_corners(x1, (x1.shape[2] * 2, x1.shape[3] * 2))
        else:
            x1 = self.up(x1)
        x1 = pad_to(x1, x2)
        x2 = nhwc_to_nchw(self._fuse(nchw_to_nhwc(x1), nchw_to_nhwc(x2)))
        return self.conv(self.conv1x1(torch.cat([x2, x1], dim=1)))


class ConvUNeXt(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1, bilinear: bool = True,
                 base_c: int = 32, generator: Optional[torch.Generator] = None):
        super().__init__()
        bc, factor = base_c, 2 if bilinear else 1
        self.in_conv = nn.Sequential(Conv2d(in_channels, bc, 7), BatchNorm2d(bc), nn.GELU(),
                                     ConvNeXtBlock(bc))
        self.down1 = _down(bc, bc * 2)
        self.down2 = _down(bc * 2, bc * 4)
        self.down3 = _down(bc * 4, bc * 8, layer_num=3)
        self.down4 = _down(bc * 8, bc * 16 // factor)
        self.up1 = Up(bc * 16, bc * 8 // factor, bilinear)
        self.up2 = Up(bc * 8, bc * 4 // factor, bilinear)
        self.up3 = Up(bc * 4, bc * 2 // factor, bilinear)
        self.up4 = Up(bc * 2, bc, bilinear)
        self.out_conv = nn.Sequential(Conv2d(bc, num_classes, 1))
        init_flax_style(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.in_conv(_reflect_pad(x))
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        h = self.up1(x5, x4)
        h = self.up2(h, x3)
        h = self.up3(h, x2)
        h = self.up4(h, x1)
        return self.out_conv(h)
