"""PVT_CASCADE in PyTorch (counterpart of `mm_unet_tpu/models/pvt_cascade.py`):
a PVTv2-b2 encoder and the CASCADE decoder. From the deepest map up, each
level passes channel attention, the one spatial attention all levels share,
and a conv block; the next level is a nearest ×2 upsample and conv, gated
against the encoder's map (an attention gate) and concatenated with it.
Four 1x1 heads, one per level, are bilinearly upsampled (half-pixel
centres) to the input size and summed.

`n_class` is the input channel count and `o_class` the class count (the
reference's naming). Module and parameter names are the torch reference's,
as `mm_unet_tpu.utils.torch_convert.pvt_cascade_pairs` tabulates them
(backbone; decoder.SA, Conv_1x1, CA1-4, ConvBlock1-4, Up1-3, AG1-3;
out_head1-4).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import BatchNorm2d, Conv2d, init_flax_style
from mm_unet_tpu_torch.models.pvtv2 import pvt_v2_b2


def _up(x: torch.Tensor, scale: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=False)


class ConvBlock(nn.Module):
    def __init__(self, ch_in: int, ch_out: int):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(ch_in, ch_out, 3, padding=1), BatchNorm2d(ch_out), nn.ReLU(),
            Conv2d(ch_out, ch_out, 3, padding=1), BatchNorm2d(ch_out), nn.ReLU())

    def forward(self, x):
        return self.conv(x)


class UpConv(nn.Module):
    """Nearest ×2 (the reference's bare `nn.Upsample(scale_factor=2)`), 3x3
    conv, BatchNorm, ReLU."""

    def __init__(self, ch_in: int, ch_out: int):
        super().__init__()
        self.up = nn.Sequential(nn.Upsample(scale_factor=2), Conv2d(ch_in, ch_out, 3, padding=1),
                                BatchNorm2d(ch_out), nn.ReLU())

    def forward(self, x):
        return self.up(x)


class AttentionGate(nn.Module):
    """x * sigmoid(BN(1x1(ReLU(BN(1x1 g) + BN(1x1 x)))))."""

    def __init__(self, f_g: int, f_l: int, f_int: int):
        super().__init__()
        self.W_g = nn.Sequential(Conv2d(f_g, f_int, 1), BatchNorm2d(f_int))
        self.W_x = nn.Sequential(Conv2d(f_l, f_int, 1), BatchNorm2d(f_int))
        self.psi = nn.Sequential(Conv2d(f_int, 1, 1), BatchNorm2d(1))

    def forward(self, g, x):
        return x * torch.sigmoid(self.psi(F.relu(self.W_g(g) + self.W_x(x))))


class ChannelAttention(nn.Module):
    """sigmoid(mlp(mean) + mlp(max)) over the pixels, the mlp two bias-free
    1x1 convs through planes / 16."""

    def __init__(self, planes: int):
        super().__init__()
        self.fc1 = Conv2d(planes, planes // 16, 1, bias=False)
        self.fc2 = Conv2d(planes // 16, planes, 1, bias=False)

    def forward(self, x):
        def mlp(v):
            return self.fc2(F.relu(self.fc1(v)))

        return torch.sigmoid(mlp(x.mean((2, 3), keepdim=True)) + mlp(x.amax((2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """sigmoid(7x7 conv of [channel mean, channel max])."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(2, 1, 7, padding=3, bias=False)

    def forward(self, x):
        return torch.sigmoid(self.conv1(torch.cat([x.mean(1, keepdim=True),
                                                   x.amax(1, keepdim=True)], dim=1)))


class CASCADE(nn.Module):
    def __init__(self, channels=(512, 320, 128, 64)):
        super().__init__()
        c = channels
        self.Conv_1x1 = Conv2d(c[0], c[0], 1)
        self.ConvBlock4 = ConvBlock(c[0], c[0])
        self.SA = SpatialAttention()
        self.CA4 = ChannelAttention(c[0])
        for n, (cin, cout, f_int) in zip((3, 2, 1), ((c[0], c[1], c[2]), (c[1], c[2], c[3]),
                                                    (c[2], c[3], 32))):
            self.add_module(f"Up{n}", UpConv(cin, cout))
            self.add_module(f"AG{n}", AttentionGate(cout, cout, f_int))
            self.add_module(f"CA{n}", ChannelAttention(2 * cout))
            self.add_module(f"ConvBlock{n}", ConvBlock(2 * cout, cout))

    def attend(self, ca: nn.Module, block: nn.Module, d: torch.Tensor) -> torch.Tensor:
        d = ca(d) * d
        return block(self.SA(d) * d)

    def forward(self, x4, skips):
        """The four levels' outputs, deepest first; `skips` the encoder's
        1/16, 1/8 and 1/4 maps."""
        d = self.attend(self.CA4, self.ConvBlock4, self.Conv_1x1(x4))
        outs = [d]
        for n, skip in zip((3, 2, 1), skips):
            d = getattr(self, f"Up{n}")(d)
            d = torch.cat([getattr(self, f"AG{n}")(d, skip), d], dim=1)
            d = self.attend(getattr(self, f"CA{n}"), getattr(self, f"ConvBlock{n}"), d)
            outs.append(d)
        return outs


class PVT_CASCADE(nn.Module):
    def __init__(self, n_class: int = 3, o_class: int = 1, model_dir: str = "",
                 generator: Optional[torch.Generator] = None):
        """`model_dir` names the reference's pretrained-backbone `.pth` (not in
        the repo): the constructor does not read it; `create_train_state`
        warm-starts the backbone from it (`utils/torch_convert.py::warm_start`),
        as the JAX package's does."""
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.backbone = pvt_v2_b2(g, n_class)
        self.decoder = CASCADE()
        for n, ch in zip((1, 2, 3, 4), (512, 320, 128, 64)):
            self.add_module(f"out_head{n}", Conv2d(ch, o_class, 1))
        init_flax_style(self, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2, x3, x4 = self.backbone(x)
        outs = self.decoder(x4, (x3, x2, x1))
        return sum(_up(getattr(self, f"out_head{n}")(d), scale)
                   for n, d, scale in zip((1, 2, 3, 4), outs, (32, 16, 8, 4)))
