"""Frozen plain reference of UM_Net, MM_Net's DSConv-based predecessor, in
f32: a ResNet-34 encoder, 1x1 channel reducers, the CBAM contour branch,
three reverse-context gates with a forward-only Mamba at twice their
resolution, dynamic-snake (DSConv, morph 0) decoder and side-output blocks,
the HPPF pyramid head, and as output the final head plus the contour map and
the four side outputs, bilinearly resized to the input.

Module and parameter names follow the torch reference's, so one state dict
fits this model and the program's. Every block but the dropout sites is
recomputed in the backward pass, as in `mm_net.py`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .plain import (BatchNorm2d, CBAM, Conv2d, ConvTranspose2d, Dropout2d, GroupNorm, Mamba,
                    Quant, Remat, identity, offsets_from_centre, remat, resize, row_sample_conv,
                    set_quant)


class DSConv(nn.Module):
    """offset conv 3x3 -> GroupNorm(k) -> tanh -> row coordinates (the
    cumulative offsets from the kernel centre) -> the row-sample (k, 1) conv
    -> GroupNorm(out / 4)."""

    def __init__(self, cin: int, cout: int, k: int = 9):
        super().__init__()
        self.k, self.quant = k, identity
        self.offset_conv = Conv2d(cin, 2 * k, 3, padding=1)
        self.gn_offset = GroupNorm(k, 2 * k)
        self.dsc_conv_x = nn.Conv2d(cin, cout, (k, 1), stride=(k, 1))
        self.gn = GroupNorm(cout // 4, cout)

    def forward(self, x):
        h = x.shape[2]
        off = torch.tanh(self.gn_offset(self.offset_conv(x)))[:, :self.k].permute(0, 2, 3, 1)
        rows = torch.arange(h, dtype=x.dtype, device=x.device)[None, :, None, None]
        y = rows + offsets_from_centre(off)
        out = row_sample_conv(x.permute(0, 2, 3, 1), y, self.dsc_conv_x.weight,
                              self.dsc_conv_x.bias, self.quant)
        return self.gn(out)


def ds_bn_relu(cin, cout):
    return Remat(DSConv(cin, cout), BatchNorm2d(cout), nn.ReLU())


class BasicBlock(nn.Module):
    def __init__(self, cin: int, feats: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, feats, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(feats)
        self.conv2 = Conv2d(feats, feats, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(feats)
        self.downsample = None
        if stride != 1 or cin != feats:
            self.downsample = nn.Sequential(Conv2d(cin, feats, 1, stride=stride, bias=False),
                                            BatchNorm2d(feats))

    def forward(self, x):
        return remat(self._forward, x)

    def _forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class RCG(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ds_bn_relu(128, 64)
        self.upsample = ConvTranspose2d(64, 64, 4, stride=2, padding=1)
        self.mamba = Mamba(64, bimamba_type="none")
        self.downsample = Conv2d(64, 64, 4, stride=2, padding=1)
        self.mlp = nn.Sequential(Conv2d(64, 1, 1), nn.Sigmoid())

    def forward(self, pre, edge, f):
        r = (1.0 - torch.sigmoid(pre)) * f
        x2 = self.conv1(torch.cat([resize(edge, f.shape[2:]), r], dim=1))
        x0 = self.upsample(x2)
        b, c, h2, w2 = x0.shape
        out = self.mamba(x0.permute(0, 2, 3, 1).reshape(b, h2 * w2, c))
        out = out.reshape(b, h2, w2, c).permute(0, 3, 1, 2)
        return self.downsample(out) * self.mlp(x2) * x2 + f


class DecoderBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = ds_bn_relu(cin, cin // 4)
        self.conv2 = ds_bn_relu(cin // 4, cout)

    def forward(self, x):
        x = self.conv2(self.conv1(x))
        return resize(x, (x.shape[2] * 2, x.shape[3] * 2))


class SideoutBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = ds_bn_relu(cin, cin // 4)
        self.drop = Dropout2d(0.1)
        self.conv2 = Conv2d(cin // 4, cout, 1)

    def forward(self, x):
        return self.conv2(self.drop(self.conv1(x)))


class HPPF(nn.Module):
    """Pyramid pooling attention over (x1, and x2, x3 resized to x1)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Sequential(DSConv(c, c // 16), nn.ReLU())
        self.conv2 = nn.Sequential(Conv2d(c, c // 64, 1), nn.ReLU())
        self.mlp = nn.Sequential(Conv2d(c, c // 8, 1), nn.ReLU(), Conv2d(c // 8, c, 1),
                                 nn.Sigmoid())
        self.feat_conv = nn.Sequential(Conv2d(c, c // 3, 3, padding=1), BatchNorm2d(c // 3),
                                       nn.ReLU())

    def forward(self, x1, x2, x3):
        hw = x1.shape[2:]
        feat = torch.cat([x1, resize(x2, hw), resize(x3, hw)], dim=1)
        b, c, h, w = feat.shape
        y1 = feat.mean((2, 3), keepdim=True)
        y2 = self.conv1(F.max_pool2d(feat, (h // 4, w // 4))).reshape(b, c, 1, 1)
        y3 = self.conv2(F.max_pool2d(feat, (h // 8, w // 8))).reshape(b, c, 1, 1)
        return self.feat_conv(self.mlp((y1 + y2 + y3) / 3.0) * feat)


class UMNet(nn.Module):
    """(B, 3, H, W) -> (B, num_classes, H, W) logits."""

    def __init__(self, num_classes: int = 1):
        super().__init__()
        self.encoder1_conv = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.encoder1_bn = BatchNorm2d(64)
        for i, (cin, w, n) in enumerate(((64, 64, 3), (64, 128, 4), (128, 256, 6),
                                         (256, 512, 3))):
            s = 2 if i else 1
            self.add_module(f"encoder{i + 2}", nn.Sequential(
                BasicBlock(cin, w, s), *(BasicBlock(w, w) for _ in range(n - 1))))
        for i, cin in ((3, 128), (4, 256), (5, 512)):
            self.add_module(f"down{i}", nn.Sequential(Conv2d(cin, 64, 1), BatchNorm2d(64),
                                                      nn.ReLU()))
        self.decoder5 = DecoderBlock(64, 64)
        self.side5 = SideoutBlock(64, num_classes)
        self.cbam = Remat(
            Conv2d(64, 64, 3, padding=1), BatchNorm2d(64), nn.ReLU(), CBAM(64),
            Conv2d(64, 64, 3, padding=1), BatchNorm2d(64), nn.ReLU())
        self.line_predict = Conv2d(64, 1, 3, padding=1)
        for n in (4, 3, 2):
            self.add_module(f"rcg{n}", RCG())
            self.add_module(f"decoder{n}", DecoderBlock(128, 64))
            self.add_module(f"side{n}", SideoutBlock(64, num_classes))
        self.hpp = HPPF(192)
        self.final = nn.Sequential(Conv2d(64, 32, 3, padding=1), BatchNorm2d(32), nn.ReLU(),
                                   Dropout2d(0.1), Conv2d(32, num_classes, 1))

    def forward(self, x):
        e1 = F.relu(self.encoder1_bn(self.encoder1_conv(x)))
        e2 = self.encoder2(F.max_pool2d(e1, 3, 2, 1))
        l2 = self.encoder3(e2)
        l3 = self.encoder4(l2)
        l4 = self.encoder5(l3)
        e3, e4, e5 = self.down3(l2), self.down4(l3), self.down5(l4)
        d5 = self.decoder5(e5)
        out5 = self.side5(d5)
        c1 = self.cbam(e1)
        p_c = self.line_predict(c1)
        d4 = self.decoder4(torch.cat([d5, self.rcg4(out5, c1, e4)], dim=1))
        out4 = self.side4(d4)
        d3 = self.decoder3(torch.cat([d4, self.rcg3(out4, c1, e3)], dim=1))
        out3 = self.side3(d3)
        d2 = self.decoder2(torch.cat([d3, self.rcg2(out3, c1, e2)], dim=1))
        out2 = self.side2(d2)
        out1 = self.final(self.hpp(d2, d3, d4))
        return sum(resize(o, x.shape[2:]) for o in (out1, out2, out3, out4, out5, p_c))


def build(cfg: dict, quant: Quant = identity) -> nn.Module:
    """The reference for a configuration file's `model_kwargs`; `quant`
    rounds the inputs of every product (`plain.py`)."""
    return set_quant(UMNet(num_classes=cfg["model_kwargs"].get("num_classes", 1)), quant)
