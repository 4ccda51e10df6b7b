"""CFPNet in PyTorch (counterpart of `mm_unet_tpu/models/cfpnet.py`): a
light dilated segmenter. Three init convs, the input injected at 1/2, 1/4
and 1/8 by average pools, two stages of channel-wise feature pyramid
modules (four branches of asymmetric grouped dilated convs, added
hierarchically), a 1x1 classifier and a linear upsampling with half-pixel
centres back to the input size.

`.eval()` is the JAX model's `train=False`; `.train()` normalises with the
batch statistics (BatchNorm eps 1e-3, as the reference's). Module and
parameter names are the torch reference's (`src/CFPnet/CFPnet.py`), as
`mm_unet_tpu.utils.torch_convert.cfpnet_pairs` tabulates them
(init_conv.0.conv, init_conv.0.bn_prelu.acti, bn_prelu_1.bn,
downsample_1.conv3x3, CFP_Block_1.CFP_Module_1_0.dconv3x1_1_1,
classifier.0.conv), so `utils.convert` maps JAX variables onto this model.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import BatchNorm2d, Conv2d, init_flax_style, resize_linear


class BNPReLU(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.bn = BatchNorm2d(channels, eps=1e-3)
        self.acti = nn.PReLU(channels, init=0.25)

    def forward(self, x):
        return self.acti(self.bn(x))


class ConvBA(nn.Module):
    """A bias-free conv padded to keep the size (at stride 1), optionally
    followed by BNPReLU (the reference's `Conv`)."""

    def __init__(self, n_in: int, n_out: int, ksize, stride: int = 1, dilation=(1, 1),
                 groups: int = 1, bn_acti: bool = False):
        super().__init__()
        kh, kw = ksize if isinstance(ksize, tuple) else (ksize, ksize)
        pad = ((dilation[0] * (kh - 1)) // 2, (dilation[1] * (kw - 1)) // 2)
        self.conv = Conv2d(n_in, n_out, (kh, kw), stride=stride, padding=pad, dilation=dilation,
                           groups=groups, bias=False)
        self.bn_prelu = BNPReLU(n_out) if bn_acti else nn.Identity()

    def forward(self, x):
        return self.bn_prelu(self.conv(x))


class CFPModule(nn.Module):
    def __init__(self, n: int, d: int = 1):
        super().__init__()
        g4, g8, g16 = n // 4, n // 8, n // 16
        self.bn_relu_1 = BNPReLU(n)
        self.conv1x1_1 = ConvBA(n, g4, 3, bn_acti=True)
        for b, dil in enumerate((1, int(d / 4 + 1), int(d / 2 + 1), d + 1), start=1):
            # (in, out) of the three 3x1 (groups n/16) and 1x3 (depthwise)
            # pairs of one branch
            for j, (cin, cout) in enumerate(((g4, g16), (g16, g16), (g16, g8)), start=1):
                setattr(self, f"dconv3x1_{b}_{j}", ConvBA(cin, cout, (3, 1), dilation=(dil, 1),
                                                          groups=g16, bn_acti=True))
                setattr(self, f"dconv1x3_{b}_{j}", ConvBA(cout, cout, (1, 3), dilation=(1, dil),
                                                          groups=cout, bn_acti=True))
        self.bn_relu_2 = BNPReLU(n)
        self.conv1x1 = ConvBA(n, n, 1)

    def _branch(self, b: int, h):
        outs = []
        for j in (1, 2, 3):
            h = getattr(self, f"dconv1x3_{b}_{j}")(getattr(self, f"dconv3x1_{b}_{j}")(h))
            outs.append(h)
        return torch.cat(outs, dim=1)

    def forward(self, x):
        inp = self.conv1x1_1(self.bn_relu_1(x))
        added, acc = [], 0
        for b in range(1, 5):  # hierarchical addition of the four branches
            acc = acc + self._branch(b, inp)
            added.append(acc)
        return self.conv1x1(self.bn_relu_2(torch.cat(added, dim=1))) + x


class DownSamplingBlock(nn.Module):
    """A 3x3 stride-2 conv, concatenated with a 2x2 max pool of the input
    when the block widens, then BNPReLU."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.pool = n_in < n_out
        self.conv3x3 = ConvBA(n_in, n_out - n_in if self.pool else n_out, 3, stride=2)
        self.bn_prelu = BNPReLU(n_out)

    def forward(self, x):
        out = self.conv3x3(x)
        if self.pool:
            out = torch.cat([out, F.max_pool2d(x, 2)], dim=1)
        return self.bn_prelu(out)


def _inject(x: torch.Tensor, ratio: int) -> torch.Tensor:
    for _ in range(ratio):  # AvgPool2d(3, 2, padding=1), padding counted
        x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)
    return x


class CFPNet(nn.Module):
    def __init__(self, classes: int = 1, block_1: int = 2, block_2: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.init_conv = nn.Sequential(ConvBA(3, 32, 3, stride=2, bn_acti=True),
                                       ConvBA(32, 32, 3, bn_acti=True),
                                       ConvBA(32, 32, 3, bn_acti=True))
        self.bn_prelu_1 = BNPReLU(35)
        self.downsample_1 = DownSamplingBlock(35, 64)
        self.CFP_Block_1 = nn.Sequential()
        for i in range(block_1):
            self.CFP_Block_1.add_module(f"CFP_Module_1_{i}", CFPModule(64, d=2))
        self.bn_prelu_2 = BNPReLU(131)
        self.downsample_2 = DownSamplingBlock(131, 128)
        self.CFP_Block_2 = nn.Sequential()
        dil2 = (4, 4, 8, 8, 16, 16)
        for i in range(block_2):
            self.CFP_Block_2.add_module(f"CFP_Module_2_{i}", CFPModule(128, d=dil2[i % 6]))
        self.bn_prelu_3 = BNPReLU(259)
        self.classifier = nn.Sequential(ConvBA(259, classes, 1))
        init_flax_style(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn_prelu_1(torch.cat([self.init_conv(x), _inject(x, 1)], dim=1))
        h1_0 = self.downsample_1(h)
        h = self.bn_prelu_2(torch.cat([self.CFP_Block_1(h1_0), h1_0, _inject(x, 2)], dim=1))
        h2_0 = self.downsample_2(h)
        h = self.bn_prelu_3(torch.cat([self.CFP_Block_2(h2_0), h2_0, _inject(x, 3)], dim=1))
        return resize_linear(self.classifier(h), x.shape[2:])
