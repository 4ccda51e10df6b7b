"""CFANet in PyTorch (counterpart of `mm_unet_tpu/models/cfanet.py`): a
deep-stem Res2Net-50 encoder; a gate fusion of the two shallow maps at 1/8;
an edge decoder up to full size (three conv stages, each after a ×2
upsample); two CFF cross-fusions of the deeper maps at 1/8; and two
saliency cascades, each four BAM stages gated by the edge decoder's maps
under channel attention. The output is the edge map plus three saliency
maps (one per cascade, one of their fused last stage), summed.

Resizes are bilinear with align_corners=True. `in_class` is the input
channel count and `out_class` the class count. Module and parameter names
are the torch reference's, as `mm_unet_tpu.utils.torch_convert.
cfanet_pairs` tabulates them (resnet; layer0, layer1, low_fusion,
layer_edge0-3, atten_edge_*, high_fusion1/2, cat_*, layer_hig*, layer_fil).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    init_flax_style,
    resize_bilinear_align_corners,
)
from mm_unet_tpu_torch.models.resnet import Res2Net50Encoder


def _up(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    return resize_bilinear_align_corners(x, (x.shape[2] * scale, x.shape[3] * scale))


def conv_bn_relu(cin: int, cout: int, kernel: int = 3, stride: int = 1) -> nn.Sequential:
    """k x k conv (stride s, padding k // 2, with bias), BatchNorm, ReLU."""
    return nn.Sequential(Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2),
                         BatchNorm2d(cout), nn.ReLU())


def conv_head(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(Conv2d(cin, cout, 1))


class BasicConv2d(nn.Module):
    """Conv (no bias, padding k // 2) and BatchNorm, no activation."""

    def __init__(self, in_planes: int, out_planes: int, kernel: int = 3):
        super().__init__()
        self.conv = Conv2d(in_planes, out_planes, kernel, padding=kernel // 2, bias=False)
        self.bn = BatchNorm2d(out_planes)

    def forward(self, x):
        return self.bn(self.conv(x))


class ChannelAttention(nn.Module):
    """sigmoid of two bias-free 1x1 convs (through in_planes / 16, ReLU) of
    the max over the pixels."""

    def __init__(self, in_planes: int):
        super().__init__()
        self.fc1 = Conv2d(in_planes, in_planes // 16, 1, bias=False)
        self.fc2 = Conv2d(in_planes // 16, in_planes, 1, bias=False)

    def forward(self, x):
        return torch.sigmoid(self.fc2(F.relu(self.fc1(x.amax((2, 3), keepdim=True)))))


class GateFusion(nn.Module):
    """x1 and x2 weighted by the softmax of two 1x1 convs of [x1, x2]."""

    def __init__(self, in_planes: int):
        super().__init__()
        self.gate_1 = Conv2d(2 * in_planes, 1, 1)
        self.gate_2 = Conv2d(2 * in_planes, 1, 1)

    def forward(self, x1, x2):
        cat = torch.cat([x1, x2], dim=1)
        att = torch.cat([self.gate_1(cat), self.gate_2(cat)], dim=1).softmax(dim=1)
        return x1 * att[:, :1] + x2 * att[:, 1:]


class GlobalModule(nn.Module):
    """sigmoid(BN(1x1(ReLU(BN(1x1(mean over the pixels)))))), through
    channels / r."""

    def __init__(self, channels: int, r: int = 4):
        super().__init__()
        self.global_att = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), Conv2d(channels, channels // r, 1),
            BatchNorm2d(channels // r), nn.ReLU(), Conv2d(channels // r, channels, 1),
            BatchNorm2d(channels))

    def forward(self, x):
        return torch.sigmoid(self.global_att(x))


class BAM(nn.Module):
    """x + conv(x, attention) * its global gate."""

    def __init__(self, channel: int):
        super().__init__()
        self.conv_layer = BasicConv2d(2 * channel, channel, 3)
        self.global_att = GlobalModule(channel)

    def forward(self, x, boun_atten):
        out1 = self.conv_layer(torch.cat([x, boun_atten], dim=1))
        return x + out1 * self.global_att(out1)


class CFF(nn.Module):
    """Cross-feature fusion of x0 and x1: 1x1 conv + BN of each to half the
    width, 3x3 and 5x5 ConvBNReLUs over both orders, twice; out =
    ConvBNReLU(x0' + x1' + x3 * x5)."""

    def __init__(self, in_channel0: int, in_channel1: int, out_channel: int):
        super().__init__()
        half = out_channel // 2
        self.layer0 = BasicConv2d(in_channel0, half, 1)
        self.layer1 = BasicConv2d(in_channel1, half, 1)
        self.layer3_1 = conv_bn_relu(2 * half, half, 3)
        self.layer5_1 = conv_bn_relu(2 * half, half, 5)
        self.layer3_2 = conv_bn_relu(2 * half, half, 3)
        self.layer5_2 = conv_bn_relu(2 * half, half, 5)
        self.layer_out = conv_bn_relu(half, out_channel, 3)

    def forward(self, x0, x1):
        x0_1, x1_1 = self.layer0(x0), self.layer1(x1)
        x31 = self.layer3_1(torch.cat([x0_1, x1_1], dim=1))
        x51 = self.layer5_1(torch.cat([x1_1, x0_1], dim=1))
        x32 = self.layer3_2(torch.cat([x31, x51], dim=1))
        x52 = self.layer5_2(torch.cat([x51, x31], dim=1))
        return self.layer_out(x0_1 + x1_1 + x32 * x52)


class CFANet(nn.Module):
    def __init__(self, in_class: int = 3, out_class: int = 1, channel: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        ch = channel
        self.resnet = Res2Net50Encoder(in_class)
        self.layer0 = conv_bn_relu(64, ch, 3, stride=2)
        self.layer1 = conv_bn_relu(256, ch, 3, stride=2)
        self.low_fusion = GateFusion(ch)
        self.layer_edge0 = conv_bn_relu(ch, ch)
        self.layer_edge1 = conv_bn_relu(ch, ch)
        self.layer_edge2 = conv_bn_relu(ch, 64)
        self.layer_edge3 = conv_head(64, out_class)
        for name in ("ori", "0", "1", "2"):
            self.add_module(f"atten_edge_{name}", ChannelAttention(ch))
        self.high_fusion1 = CFF(256, 512, ch)
        self.high_fusion2 = CFF(1024, 2048, ch)
        for s in ("1", "2"):
            for i, dim in enumerate((ch, ch, ch, 64)):
                self.add_module(f"cat_{i}{s}", BAM(dim))
                if i < 3:
                    self.add_module(f"layer_hig{i}{s}", conv_bn_relu(ch, 64 if i == 2 else ch))
            self.add_module(f"layer_hig3{s}", conv_head(64, out_class))
        self.layer_fil = conv_head(64, out_class)
        init_flax_style(self, g)

    def cascade(self, high, gates, s: str):
        """Four BAM stages (each but the last followed by a ×2 upsample and a
        ConvBNReLU) gated by `gates`: (the last stage, its saliency map)."""
        h = high
        for i, gate in enumerate(gates):
            h = getattr(self, f"cat_{i}{s}")(h, gate)
            if i < 3:
                h = getattr(self, f"layer_hig{i}{s}")(_up(h))
        return h, getattr(self, f"layer_hig3{s}")(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0, x1, x2, x3, x4 = self.resnet(x)
        low_x = self.low_fusion(self.layer0(x0), self.layer1(x1))
        edge0 = self.layer_edge0(_up(low_x))
        edge1 = self.layer_edge1(_up(edge0))
        edge2 = self.layer_edge2(_up(edge1))
        edge3 = self.layer_edge3(edge2)
        gates = [m * getattr(self, f"atten_edge_{n}")(m)
                 for n, m in zip(("ori", "0", "1", "2"), (low_x, edge0, edge1, edge2))]
        high1 = self.high_fusion1(F.max_pool2d(x1, 2, 2), x2)
        high2 = self.high_fusion2(_up(x3), _up(x4, 4))
        cat31, sal1 = self.cascade(high1, gates, "1")
        cat32, sal2 = self.cascade(high2, gates, "2")
        return edge3 + sal1 + sal2 + self.layer_fil(cat31 + cat32)
