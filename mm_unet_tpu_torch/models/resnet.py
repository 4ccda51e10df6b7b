"""The ResNet-34 and Res2Net-50 encoders (counterpart of
`mm_unet_tpu/models/resnet.py`).

`BasicBlock` and `ResNet34Encoder` (`resnet.py:22-63`, UM_Net's):
torchvision's resnet34 stem and stages, NCHW, with torchvision's module
names (conv1, bn1, layer1..4; blocks conv1, bn1, conv2, bn2,
downsample.0/.1), so `mm_unet_tpu.utils.torch_convert.
resnet34_encoder_pairs` maps the JAX encoder onto it. The stem pads its
7x7 stride-2 conv by 3 on every side, as torch does (SAME would pad 2 and
3).

`Bottle2neck` and `Res2Net50Encoder` (`resnet.py:65-139`, CFANet's): the
deep-stem Res2Net-50 v1b, with the reference's names (conv1.0/.1/.3/.4/.6,
bn1, layer1..4; blocks conv1, bn1, convs.i, bns.i, conv3, bn3,
downsample.1/.2), as `res2net50_pairs` tabulates them. Pools follow flax's
and torch's shared conventions: the stage blocks' 3x3 stride-s average
pool of the last split pads by 1 and divides by 9 wherever the window
hangs over the edge (count_include_pad, flax's default), the shortcut's
s x s stride-s average pool is unpadded (floor), and the stem's 3x3
stride-2 max pool pads by 1 with -inf.
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


class Bottle2neck(nn.Module):
    """Res2Net bottleneck: 1x1 conv to `scale` splits of `width` channels;
    each of the first scale - 1 splits (plus the previous one's output,
    except in a stage's first block) through a 3x3 conv (stride s) + BN +
    ReLU; the last split as it is, or 3x3 average-pooled (stride s) in a
    stage's first block; 1x1 conv + BN to 4 x planes, plus the shortcut
    (s x s average pool when s > 1, then 1x1 conv + BN, in a stage's first
    block); ReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, scale: int = 4,
                 base_width: int = 26, downsample: bool = False):
        super().__init__()
        width = int(planes * (base_width / 64.0))
        self.width, self.stride, self.stage = width, stride, downsample
        self.conv1 = Conv2d(inplanes, width * scale, 1, bias=False)
        self.bn1 = BatchNorm2d(width * scale)
        self.convs = nn.ModuleList([Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
                                    for _ in range(scale - 1)])
        self.bns = nn.ModuleList([BatchNorm2d(width) for _ in range(scale - 1)])
        self.conv3 = Conv2d(width * scale, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = None
        if downsample or inplanes != planes * 4:
            pool = nn.AvgPool2d(stride, stride) if stride > 1 else nn.Identity()
            self.downsample = nn.Sequential(pool, Conv2d(inplanes, planes * 4, 1, bias=False),
                                            BatchNorm2d(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        splits = F.relu(self.bn1(self.conv1(x))).split(self.width, dim=1)
        ys, sp = [], None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = splits[i] if i == 0 or self.stage else sp + splits[i]
            sp = F.relu(bn(conv(sp)))
            ys.append(sp)
        last = splits[-1]
        if self.stage:
            last = F.avg_pool2d(last, 3, self.stride, 1)
        out = self.bn3(self.conv3(torch.cat([*ys, last], dim=1)))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class Res2Net50Encoder(nn.Module):
    """(B, C, H, W) -> (x0, layer1, layer2, layer3, layer4): the deep stem's
    max-pooled output (64 channels at H/4), then the four stages at 256,
    512, 1024 and 2048 channels (H/4 .. H/32)."""

    def __init__(self, in_channels: int = 3, blocks: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        self.conv1 = nn.Sequential(
            Conv2d(in_channels, 32, 3, stride=2, padding=1, bias=False), BatchNorm2d(32),
            nn.ReLU(), Conv2d(32, 32, 3, padding=1, bias=False), BatchNorm2d(32), nn.ReLU(),
            Conv2d(32, 64, 3, padding=1, bias=False))
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for i, (n, w) in enumerate(zip(blocks, widths)):
            self.add_module(f"layer{i + 1}", nn.Sequential(*(
                Bottle2neck(cin if j == 0 else 4 * w, w, 2 if i and j == 0 else 1,
                            downsample=j == 0) for j in range(n))))
            cin = 4 * w

    def forward(self, x: torch.Tensor):
        x0 = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        h, feats = x0, []
        for i in range(4):
            h = getattr(self, f"layer{i + 1}")(h)
            feats.append(h)
        return (x0, *feats)
