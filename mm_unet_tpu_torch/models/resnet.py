"""The ResNet-34 encoder (counterpart of `mm_unet_tpu/models/resnet.py:22-63`,
`BasicBlock` and `ResNet34Encoder`): torchvision's resnet34 stem and
stages, NCHW, with torchvision's module names (conv1, bn1, layer1..4;
blocks conv1, bn1, conv2, bn2, downsample.0/.1), so
`mm_unet_tpu.utils.torch_convert.resnet34_encoder_pairs` maps the JAX
encoder onto it. The stem pads its 7x7 stride-2 conv by 3 on every side,
as torch does (SAME would pad 2 and 3).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import BatchNorm2d, Conv2d


class BasicBlock(nn.Module):
    """3x3 conv (stride s) -> BN -> ReLU -> 3x3 conv -> BN, plus the input or,
    when the stride or the width changes, its strided 1x1 conv + BN; ReLU."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_channels, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(features)
        self.downsample = None
        if stride != 1 or in_channels != features:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, features, 1, stride=stride, bias=False),
                BatchNorm2d(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


def resnet_stage(in_channels: int, width: int, blocks: int, stride: int) -> nn.Sequential:
    """`blocks` BasicBlocks at `width`, the first with `stride`."""
    return nn.Sequential(BasicBlock(in_channels, width, stride),
                         *(BasicBlock(width, width) for _ in range(blocks - 1)))


class ResNet34Encoder(nn.Module):
    """(B, 3, H, W) -> (e1, layer1, layer2, layer3, layer4): the stem's output
    before its max pool (64 channels at H/2), then the four stages at 64,
    128, 256 and 512 channels (H/4 .. H/32)."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for i, (n, w) in enumerate(zip(blocks, widths)):
            self.add_module(f"layer{i + 1}", resnet_stage(cin, w, n, 2 if i else 1))
            cin = w

    def forward(self, x: torch.Tensor):
        e1 = F.relu(self.bn1(self.conv1(x)))
        h, feats = F.max_pool2d(e1, 3, 2, 1), []
        for i in range(4):
            h = getattr(self, f"layer{i + 1}")(h)
            feats.append(h)
        return (e1, *feats)
