"""Frozen plain reference of MM_Net, the Morph-Mamba U-Net (MM-UNet, BIBM
2025), in f32: a ResNet-like encoder whose blocks are Morph-Mamba
deformable convolutions (MMConv), 1x1 MMConv channel reducers, a decoder of
MMConv blocks with reverse-context gates (RCG) that run a bidirectional
slice Mamba at twice their resolution, a CBAM contour branch, and as output
the sum of four side outputs and the contour logits, bilinearly resized to
the input.

Module and parameter names follow the torch reference's, so one state dict
fits this model and the program's. Every block but the side outputs'
dropout is recomputed in the backward pass (`plain.remat`), so that the
reference trains at a benchmark's batch on one card.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .plain import (BatchNorm2d, CBAM, Conv2d, ConvTranspose2d, Dropout2d, GroupNorm, Mamba,
                   Quant, Remat, identity, offsets_from_centre, remat, resize, row_sample_conv,
                   two_row_flatten, two_row_unflatten)


class MMConv(nn.Module):
    """offset conv 3x3 -> GroupNorm(k) -> tanh -> row coordinates: the
    cumulative offsets from the kernel centre plus softplus(altho) times a
    TFM Mamba over the offsets in two-row serpentine order -> the row-sample
    (k, 1) conv -> GroupNorm(out / 4)."""

    def __init__(self, cin: int, cout: int, k: int, num_slices: int, quant: Quant):
        super().__init__()
        self.k, self.quant = k, quant
        self.altho = nn.Parameter(torch.tensor(math.log(math.e - 1.0)))
        self.offset_conv = Conv2d(cin, 2 * k, 3, padding=1, quant=quant)
        self.gn_offset = GroupNorm(k, 2 * k)
        self.mamba = Mamba(k, nslices=num_slices, quant=quant)
        self.dsc_conv_x = nn.Conv2d(cin, cout, (k, 1), stride=(k, 1))
        self.gn = GroupNorm(cout // 4, cout)

    def forward(self, x):
        _, _, h, w = x.shape
        k = self.k
        off = torch.tanh(self.gn_offset(self.offset_conv(x)))[:, :k].permute(0, 2, 3, 1)
        rows = torch.arange(h, dtype=x.dtype, device=x.device)[None, :, None, None]
        y_new = rows + offsets_from_centre(off)
        y_keep = two_row_unflatten(self.mamba(two_row_flatten(off)), h, w)
        y = torch.clamp(F.softplus(self.altho), min=0.01) * y_keep + y_new
        out = row_sample_conv(x.permute(0, 2, 3, 1), y, self.dsc_conv_x.weight,
                              self.dsc_conv_x.bias, self.quant)
        return self.gn(out)


def mm_bn_relu(cin, cout, k, ns, q):
    return Remat(MMConv(cin, cout, k, ns, q), BatchNorm2d(cout), nn.ReLU())


class SideoutBlock(nn.Module):
    def __init__(self, cin, cout, ns, q, drop):
        super().__init__()
        self.conv1 = mm_bn_relu(cin, cin // 4, 3, ns, q)
        self.drop = Dropout2d(drop)
        self.conv2 = Conv2d(cin // 4, cout, 1, quant=q)

    def forward(self, x):
        return self.conv2(self.drop(self.conv1(x)))


class RCG(nn.Module):
    def __init__(self, ns, q):
        super().__init__()
        self.conv1 = mm_bn_relu(128, 64, 3, ns, q)
        self.upsample = ConvTranspose2d(64, 64, 4, stride=2, padding=1, quant=q)
        self.mamba = Mamba(64, nslices=ns, quant=q)
        self.downsample = Conv2d(64, 64, 4, stride=2, padding=1, quant=q)
        self.mlp = nn.Sequential(Conv2d(64, 1, 1, quant=q), nn.Sigmoid())

    def forward(self, pre, edge, f):
        r = (1.0 - torch.sigmoid(pre)) * f
        x2 = self.conv1(torch.cat([resize(edge, f.shape[2:]), r], dim=1))
        x0 = self.upsample(x2)
        b, c, h2, w2 = x0.shape
        out = self.mamba(x0.permute(0, 2, 3, 1).reshape(b, h2 * w2, c))
        out = out.reshape(b, h2, w2, c).permute(0, 3, 1, 2)
        return self.downsample(out) * self.mlp(x2) * x2 + f


class DecoderBlock(nn.Module):
    def __init__(self, cin, cout, ns, q):
        super().__init__()
        self.conv1 = mm_bn_relu(cin, cin // 4, 3, ns, q)
        self.conv2 = mm_bn_relu(cin // 4, cout, 3, ns, q)

    def forward(self, x):
        x = self.conv2(self.conv1(x))
        return resize(x, (x.shape[2] * 2, x.shape[3] * 2))


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, ns, downsample, q):
        super().__init__()
        self.downsample = downsample
        if downsample:
            self.block1 = nn.Sequential(
                Conv2d(cin, cout, 3, stride=2, padding=1, bias=False, quant=q),
                BatchNorm2d(cout), nn.ReLU(), MMConv(cout, cout, 3, ns, q),
                BatchNorm2d(cout))
            self.block2 = nn.Sequential(Conv2d(cin, cout, 1, stride=2, bias=False, quant=q),
                                        BatchNorm2d(cout))
        else:
            self.block1 = nn.Sequential(MMConv(cin, cout, 3, ns, q), BatchNorm2d(cout),
                                        nn.ReLU(), MMConv(cout, cout, 3, ns, q),
                                        BatchNorm2d(cout))

    def forward(self, x):
        return remat(self._forward, x)

    def _forward(self, x):
        if self.downsample:
            return F.relu(self.block2(x) + self.block1(x))
        return F.relu(self.block1(x) + x)


class MMNet(nn.Module):
    """(B, 3, H, W) -> (B, num_classes, H, W) logits."""

    def __init__(self, num_classes: int = 1, num_slices_list: Sequence[int] = (64, 32, 16, 8),
                 depths: Sequence[int] = (3, 4, 6, 3), sideout_drop: float = 0.1,
                 quant: Quant = identity):
        super().__init__()
        ns, q = list(num_slices_list), quant

        def stage(cin, cout, n_sl, depth, down):
            return nn.Sequential(ResidualBlock(cin, cout, n_sl, down, q),
                                 *(ResidualBlock(cout, cout, n_sl, False, q)
                                   for _ in range(depth - 1)))

        self.encoder1 = Remat(Conv2d(3, 64, 7, stride=2, padding=3, bias=False, quant=q),
                                      BatchNorm2d(64), nn.ReLU())
        self.encoder2 = stage(64, 64, ns[0], depths[0], False)
        self.encoder3 = stage(64, 128, ns[1], depths[1], True)
        self.encoder4 = stage(128, 256, ns[2], depths[2], True)
        self.encoder5 = stage(256, 512, ns[3], depths[3], True)
        self.down3 = mm_bn_relu(128, 64, 1, ns[-1], q)
        self.down4 = mm_bn_relu(256, 64, 1, ns[-1], q)
        self.down5 = mm_bn_relu(512, 64, 1, ns[-1], q)
        self.decoder5 = DecoderBlock(64, 64, ns[3], q)
        self.side5 = SideoutBlock(64, num_classes, ns[3], q, sideout_drop)
        self.cbam = Remat(
            Conv2d(64, 64, 3, padding=1, quant=q), BatchNorm2d(64), nn.ReLU(),
            CBAM(64, quant=q),
            Conv2d(64, 64, 3, padding=1, quant=q), BatchNorm2d(64), nn.ReLU())
        self.line_predict = Conv2d(64, 1, 3, padding=1, quant=q)
        for n, s in ((4, ns[2]), (3, ns[1]), (2, ns[0])):
            self.add_module(f"rcg{n}", RCG(s, q))
            self.add_module(f"decoder{n}", DecoderBlock(128, 64, s, q))
            self.add_module(f"side{n}", SideoutBlock(64, num_classes, s, q, sideout_drop))

    def forward(self, x):
        e1 = self.encoder1(x)
        e2 = self.encoder2(F.max_pool2d(e1, 3, 2, 1))
        e3 = self.encoder3(e2)
        e4 = self.encoder4(e3)
        e5 = self.encoder5(e4)
        e3d, e4d, e5d = self.down3(e3), self.down4(e4), self.down5(e5)
        d5 = self.decoder5(e5d)
        out5 = self.side5(d5)
        c1 = self.cbam(e1)
        p_c = self.line_predict(c1)
        d4 = self.decoder4(torch.cat([d5, self.rcg4(out5, c1, e4d)], dim=1))
        out4 = self.side4(d4)
        d3 = self.decoder3(torch.cat([d4, self.rcg3(out4, c1, e3d)], dim=1))
        out3 = self.side3(d3)
        d2 = self.decoder2(torch.cat([d3, self.rcg2(out3, c1, e2)], dim=1))
        out2 = self.side2(d2)
        return sum(resize(o, x.shape[2:]) for o in (out2, out3, out4, out5, p_c))


def build(cfg: dict, quant: Quant = identity) -> nn.Module:
    """The reference for a configuration file's `model_kwargs`."""
    kw = cfg["model_kwargs"]
    return MMNet(num_classes=kw.get("num_classes", 1),
                 num_slices_list=kw.get("num_slices_list", (64, 32, 16, 8)),
                 depths=kw.get("depths", (3, 4, 6, 3)),
                 sideout_drop=kw.get("sideout_drop", 0.1), quant=quant)
