"""The classic UNet in PyTorch (counterpart of `mm_unet_tpu/models/unet.py`):
DoubleConv, four max-pool downs, four ups (bilinear align-corners x2, or
a 2x2 stride-2 transposed conv when `bilinear=False`), each padded to its
skip and concatenated after it, and a 1x1 head.

`.eval()` is the JAX model's `train=False`; `.train()` normalises with the
batch statistics. Module and parameter names are the torch reference's
(`src/Unet/unet_parts.py`), as `mm_unet_tpu.utils.torch_convert.unet_pairs`
tabulates them (inc.double_conv.0, down1.maxpool_conv.1.double_conv.4,
up1.conv.double_conv.0, up1.up, outc.conv), so `utils.convert` maps JAX
variables onto this model.
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
    init_flax_style,
    resize_bilinear_align_corners,
)


def pad_to(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Zero-pad NCHW `x` to `skip`'s height and width, the extra row or
    column at the bottom and right (the reference's `Up.forward`)."""
    dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
    if dh == 0 and dw == 0:
        return x
    return F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


class DoubleConv(nn.Module):
    """(3x3 conv without bias, BatchNorm, ReLU) twice."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: Optional[int] = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.double_conv = nn.Sequential(
            Conv2d(in_channels, mid, 3, padding=1, bias=False), BatchNorm2d(mid), nn.ReLU(),
            Conv2d(mid, out_channels, 3, padding=1, bias=False), BatchNorm2d(out_channels),
            nn.ReLU())

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(in_channels, out_channels))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    """x1 upsampled x2 and padded to the skip x2, then DoubleConv of [x2,
    x1]. `in_channels` is the concatenation's width; bilinear, the middle
    width is x1's (half of it), as in the reference."""

    def __init__(self, in_channels: int, out_channels: int, bilinear: bool = True):
        super().__init__()
        self.bilinear = bilinear
        if bilinear:
            self.conv = DoubleConv(in_channels, out_channels, in_channels // 2)
        else:
            self.up = ConvTranspose2d(in_channels, in_channels // 2, 2, stride=2)
            self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x1, x2):
        if self.bilinear:
            x1 = resize_bilinear_align_corners(x1, (x1.shape[2] * 2, x1.shape[3] * 2))
        else:
            x1 = self.up(x1)
        return self.conv(torch.cat([x2, pad_to(x1, x2)], dim=1))


class UNet(nn.Module):
    def __init__(self, n_channels: int = 3, num_classes: int = 1, bilinear: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        factor = 2 if bilinear else 1
        self.inc = DoubleConv(n_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 1024 // factor)
        self.up1 = Up(1024, 512 // factor, bilinear)
        self.up2 = Up(512, 256 // factor, bilinear)
        self.up3 = Up(256, 128 // factor, bilinear)
        self.up4 = Up(128, 64, bilinear)
        self.outc = nn.Module()
        self.outc.conv = Conv2d(64, num_classes, 1)
        init_flax_style(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        return self.outc.conv(y)


def Unet(num_classes: int = 1, n_channels: int = 3, device: torch.device | str = "cuda",  # noqa: N802
         generator: Optional[torch.Generator] = None) -> UNet:
    """The reference's top-level mini pipeline's model (the root `model.py`):
    the UNet above with transposed-conv ups (`bilinear=False`), which makes
    it the mini `Unet` layer for layer, weights drawn from `generator`, on
    `device` in eval mode: the card unless the caller asks for the CPU."""
    from mm_unet_tpu_torch.models.registry import give_model

    return give_model("UNet", device=device, generator=generator, n_channels=n_channels,
                      num_classes=num_classes, bilinear=False)
