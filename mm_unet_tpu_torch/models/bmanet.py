"""BMANet in PyTorch (counterpart of `mm_unet_tpu/models/bmanet.py`): a
PVTv2-b2 encoder, an RFB block on each of its four maps, a dense
aggregation of the three deeper ones into a global map at 1/8, a CBR
boundary chain fused with the first map into an edge map at 1/4, and three
cascaded BMA refinement heads (background, prediction and edge attention,
then CBAM) at 1/8.

The model emits probabilities: a sigmoid comes before the last bilinear
upsample (`bmanet.py:196`), as in the JAX model and the reference; the
loss then applies its own sigmoid on top, as the JAX package's does.
Resizes are bilinear with align_corners=True. Module and parameter names
are the torch reference's, as `mm_unet_tpu.utils.torch_convert.
bmanet_pairs` tabulates them (backbone; rfb1_1-rfb4_1; agg; CBR1-4; BAM.
fusion_conv; BMA4/3/2; fuse).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    Linear,
    init_flax_style,
    resize_bilinear_align_corners,
)
from mm_unet_tpu_torch.models.pvtv2 import pvt_v2_b2


def _up(x: torch.Tensor, scale: int) -> torch.Tensor:
    return resize_bilinear_align_corners(x, (x.shape[2] * scale, x.shape[3] * scale))


class BasicConv2d(nn.Module):
    """(kh, kw) conv, dilation d, padding d (k - 1) / 2 per side, no bias;
    BatchNorm; ReLU."""

    def __init__(self, in_planes: int, out_planes: int, kernel=(1, 1), dilation: int = 1):
        super().__init__()
        kh, kw = kernel
        self.conv = Conv2d(in_planes, out_planes, (kh, kw),
                           padding=(dilation * (kh - 1) // 2, dilation * (kw - 1) // 2),
                           dilation=dilation, bias=False)
        self.bn = BatchNorm2d(out_planes)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class RFB(nn.Module):
    """A 1x1 branch and three of 1x1, (1, k), (k, 1) and a 3x3 at dilation k
    (k = 3, 5, 7); their concatenation through a 3x3, plus a 1x1 of the
    input; ReLU."""

    def __init__(self, in_channel: int, out_channel: int):
        super().__init__()
        oc = out_channel
        self.branch0 = nn.Sequential(BasicConv2d(in_channel, oc))
        for i, k in enumerate((3, 5, 7)):
            self.add_module(f"branch{i + 1}", nn.Sequential(
                BasicConv2d(in_channel, oc), BasicConv2d(oc, oc, (1, k)),
                BasicConv2d(oc, oc, (k, 1)), BasicConv2d(oc, oc, (3, 3), dilation=k)))
        self.conv_cat = BasicConv2d(4 * oc, oc, (3, 3))
        self.conv_res = BasicConv2d(in_channel, oc)

    def forward(self, x):
        cat = torch.cat([getattr(self, f"branch{i}")(x) for i in range(4)], dim=1)
        return F.relu(self.conv_cat(cat) + self.conv_res(x))


class Aggregation(nn.Module):
    """Dense aggregation of x1 (1/32), x2 (1/16), x3 (1/8): returns (the
    one-channel global map, the `channel`-wide high-level map), at 1/8."""

    def __init__(self, channel: int):
        super().__init__()
        ch = channel
        for name in ("conv_upsample1", "conv_upsample2", "conv_upsample3", "conv_upsample4"):
            self.add_module(name, BasicConv2d(ch, ch, (3, 3)))
        self.conv_upsample5 = BasicConv2d(2 * ch, 2 * ch, (3, 3))
        self.conv_concat2 = BasicConv2d(2 * ch, 2 * ch, (3, 3))
        self.conv_concat3 = BasicConv2d(3 * ch, 3 * ch, (3, 3))
        self.conv4 = BasicConv2d(3 * ch, 3 * ch, (3, 3))
        self.conv5 = Conv2d(3 * ch, 1, 1)
        self.conv6 = Conv2d(3 * ch, ch, 1)

    def forward(self, x1, x2, x3):
        x2_1 = self.conv_upsample1(_up(x1, 2)) * x2
        x3_1 = self.conv_upsample2(_up(_up(x1, 2), 2)) * self.conv_upsample3(_up(x2, 2)) * x3
        x2_2 = self.conv_concat2(torch.cat([x2_1, self.conv_upsample4(_up(x1, 2))], dim=1))
        x3_2 = self.conv_concat3(torch.cat([x3_1, self.conv_upsample5(_up(x2_2, 2))], dim=1))
        h = self.conv4(x3_2)
        return self.conv5(h), self.conv6(h)


class CBR(nn.Module):
    def __init__(self, in_channel: int, out_channel: int):
        super().__init__()
        self.cbr = nn.Sequential(Conv2d(in_channel, out_channel, 3, padding=1),
                                 BatchNorm2d(out_channel), nn.ReLU())

    def forward(self, x):
        return self.cbr(x)


class ChannelAttentionModule(nn.Module):
    """sigmoid(fc(mean) + fc(max)), one bias-free fc of two 1x1 convs."""

    def __init__(self, channel: int, ratio: int = 4):
        super().__init__()
        self.fc = nn.Sequential(Conv2d(channel, channel // ratio, 1, bias=False), nn.ReLU(),
                                Conv2d(channel // ratio, channel, 1, bias=False))

    def forward(self, x):
        return torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True))
                             + self.fc(x.amax((2, 3), keepdim=True)))


class SpatialAttentionModule(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(2, 1, 7, padding=3, bias=False)

    def forward(self, x):
        return torch.sigmoid(self.conv1(torch.cat([x.mean(1, keepdim=True),
                                                   x.amax(1, keepdim=True)], dim=1)))


class FusionConv(nn.Module):
    """1x1 conv of [x1, x2] to `inter` channels; channel attention on it,
    plus 3x3 + 5x5 + 7x7 convs of it under spatial attention; a 1x1 conv
    of their sum to `out`."""

    def __init__(self, in_channels: int, inter: int, out: int):
        super().__init__()
        d = inter
        self.down = Conv2d(in_channels, d, 1)
        self.channel_attention = ChannelAttentionModule(d)
        self.conv_3x3 = Conv2d(d, d, 3, padding=1)
        self.conv_5x5 = Conv2d(d, d, 5, padding=2)
        self.conv_7x7 = Conv2d(d, d, 7, padding=3)
        self.spatial_attention = SpatialAttentionModule()
        self.up = Conv2d(d, out, 1)

    def forward(self, x1, x2):
        h = self.down(torch.cat([x1, x2], dim=1))
        h_c = h * self.channel_attention(h)
        s = self.conv_3x3(h) + self.conv_5x5(h) + self.conv_7x7(h)
        return self.up(s * self.spatial_attention(s) + h_c)


class BAM(nn.Module):
    def __init__(self, in_channels: int, inter: int = 32, out: int = 1):
        super().__init__()
        self.fusion_conv = FusionConv(in_channels, inter, out)

    def forward(self, x1, x2):
        return self.fusion_conv(x1, x2)


class ChannelGate(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.mlp = nn.Sequential(nn.Flatten(), Linear(channels, channels // reduction), nn.ReLU(),
                                 Linear(channels // reduction, channels))

    def forward(self, x):
        att = self.mlp(x.mean((2, 3), keepdim=True)) + self.mlp(x.amax((2, 3), keepdim=True))
        return x * torch.sigmoid(att)[:, :, None, None]


class SpatialGate(nn.Module):
    """sigmoid(7x7 conv with bias of [channel max, channel mean])."""

    def __init__(self):
        super().__init__()
        self.spatial = Conv2d(2, 1, 7, padding=3)

    def forward(self, x):
        s = torch.cat([x.amax(1, keepdim=True), x.mean(1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial(s))


class CBAMBlock(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.ChannelGate = ChannelGate(channels, reduction)
        self.SpatialGate = SpatialGate()

    def forward(self, x):
        return self.SpatialGate(self.ChannelGate(x))


class BMA(nn.Module):
    """Refines `x` with the sigmoid of the upsampled prediction (background
    x (1 - p), a 1x1 conv of p) and the upsampled edge; 3x3 conv + BN +
    ReLU, a 3x3 attention conv + BN + sigmoid, plus x; CBAM; a 1x1 conv to
    one channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_pred = Conv2d(1, 1, 1)
        self.fusion_conv = nn.Sequential(Conv2d(3 * channels, channels, 3, padding=1),
                                         BatchNorm2d(channels), nn.ReLU())
        self.attention = nn.Sequential(Conv2d(channels, 1, 3, padding=1), BatchNorm2d(1),
                                       nn.Sigmoid())
        self.cbam = CBAMBlock(channels)
        self.pred = Conv2d(channels, 1, 1)

    def forward(self, edge, x, pred):
        hw = x.shape[2:]
        pred = torch.sigmoid(resize_bilinear_align_corners(pred, hw))
        h = torch.cat([x * (1 - pred), x * self.conv_pred(pred),
                       x * resize_bilinear_align_corners(edge, hw)], dim=1)
        h = self.fusion_conv(h)
        return self.pred(self.cbam(h * self.attention(h) + x))


class BMANet(nn.Module):
    def __init__(self, channel: int = 64, out_channel: int = 1, model_dir: str = "",
                 generator: Optional[torch.Generator] = None):
        """`channel` is the decoder's width. `model_dir` (the reference's
        pretrained-backbone `.pth`, not in the repo) is accepted and unused,
        as in the JAX model."""
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        ch = channel
        self.backbone = pvt_v2_b2(g)
        for i, dim in enumerate((64, 128, 320, 512)):
            self.add_module(f"rfb{i + 1}_1", RFB(dim, ch))
        self.agg = Aggregation(ch)
        for n in (4, 3, 2, 1):
            self.add_module(f"CBR{n}", CBR(ch, ch))
        self.BAM = BAM(2 * ch)
        for n in (4, 3, 2):
            self.add_module(f"BMA{n}", BMA(ch))
        self.fuse = BasicConv2d(1, out_channel)
        init_flax_style(self, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2, x3, x4 = self.backbone(x)
        r1, r2, r3, r4 = (getattr(self, f"rfb{i}_1")(f) for i, f in enumerate((x1, x2, x3, x4), 1))
        gmap, high_global = self.agg(r4, r3, r2)
        r4u, r3u = _up(r4, 4), _up(r3, 2)
        hb = self.CBR4(high_global)
        hb = self.CBR3(hb + r4u)
        hb = self.CBR2(hb + r3u)
        hb = self.CBR1(hb + r2)
        edge = self.BAM(r1, _up(hb, 2))
        s4 = self.BMA4(edge, r4u, gmap)
        s3 = self.BMA3(edge, r3u, s4)
        main = self.BMA2(edge, r2, s3)
        out = torch.sigmoid(self.fuse(main))  # probabilities, before the last upsample
        return resize_bilinear_align_corners(out, x.shape[2:])
