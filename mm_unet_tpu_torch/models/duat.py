"""DuAT in PyTorch (counterpart of `mm_unet_tpu/models/duat.py`): a PVTv2-b2
backbone, GLSA global-local attention on its three deeper maps (a ConvBranch
on one half of the channels, a global-context block on the other), SBA
boundary aggregation of the first map with the deeper ones, and the sum of
two heads bilinearly upsampled to the input size (×8 and ×4).

Resizes are bilinear with half-pixel centres, `F.interpolate(...,
align_corners=False)`, antialiasing off, as in the torch reference. Only
SBA resizes down (1/4 to 1/8, `duat.py:113`): there `jax.image.resize`
antialiases, the reference does not, and the port follows the reference
(ROADMAP.md queue 3; `layers.resize_bilinear_torch`). Everywhere else
the two agree.

Module and parameter names are the torch reference's, as
`mm_unet_tpu.utils.torch_convert.duat_pairs` tabulates them (backbone,
GLSA_c4/c3/c2 with local_11conv, local.conv1-7, global_11conv,
GlobelBlock.conv_mask and channel_mul_conv, conv1_1; fuse2, L_feature,
fuse, SBA.fc1/fc2/d_in1/d_in2/conv).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    LayerNorm,
    init_flax_style,
    resize_bilinear_torch as resize,
)
from mm_unet_tpu_torch.models.pvtv2 import pvt_v2_b2


class BasicConv2d(nn.Module):
    """k x k conv (dilation d, padding d (k - 1) / 2, no bias), BatchNorm,
    ReLU."""

    def __init__(self, in_planes: int, out_planes: int, kernel: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = Conv2d(in_planes, out_planes, kernel, padding=dilation * (kernel - 1) // 2,
                           dilation=dilation, bias=False)
        self.bn = BatchNorm2d(out_planes)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ContextBlock(nn.Module):
    """Attention pooling (a 1x1 conv's softmax over the pixels) to one
    context vector, a 1x1 conv, LayerNorm over its (C, 1, 1), ReLU and a
    zero-initialised 1x1 conv; out = x + x * sigmoid(that)."""

    def __init__(self, inplanes: int, ratio: float = 2.0):
        super().__init__()
        planes = int(inplanes * ratio)
        self.conv_mask = Conv2d(inplanes, 1, 1)
        self.channel_mul_conv = nn.Sequential(
            Conv2d(inplanes, planes, 1), LayerNorm([planes, 1, 1], eps=1e-5), nn.ReLU(),
            Conv2d(planes, inplanes, 1))

    def forward(self, x):
        b, c = x.shape[:2]
        mask = self.conv_mask(x).reshape(b, -1).softmax(dim=1)
        context = torch.einsum("bcn,bn->bc", x.flatten(2), mask)[:, :, None, None]
        return x + x * torch.sigmoid(self.channel_mul_conv(context))


def _conv_bn(f: int, k: int, groups: int = 1) -> nn.Sequential:
    return nn.Sequential(Conv2d(f, f, k, padding=k // 2, groups=groups, bias=False),
                         BatchNorm2d(f))


class ConvBranch(nn.Module):
    """Pointwise and depthwise conv + BN pairs with residuals, ReLU (SiLU
    after conv5), a last 1x1 conv; out = x + x * sigmoid(that)."""

    def __init__(self, features: int):
        super().__init__()
        f = features
        for i in range(6):
            self.add_module(f"conv{i + 1}", _conv_bn(f, 3 if i % 2 else 1, f if i % 2 else 1))
        self.conv7 = nn.Sequential(Conv2d(f, f, 1, bias=False))

    def forward(self, x):
        h = F.relu(self.conv1(x))
        h = h + F.relu(self.conv2(h))
        h = F.relu(self.conv3(h))
        h = h + F.relu(self.conv4(h))
        h = F.silu(self.conv5(h))
        h = h + F.relu(self.conv6(h))
        return x + x * torch.sigmoid(F.relu(self.conv7(h)))


class GLSA(nn.Module):
    def __init__(self, input_dim: int, embed_dim: int = 32):
        super().__init__()
        half = input_dim // 2
        self.local_11conv = Conv2d(half, embed_dim, 1)
        self.local = ConvBranch(embed_dim)
        self.global_11conv = Conv2d(input_dim - half, embed_dim, 1)
        self.GlobelBlock = ContextBlock(embed_dim)
        self.conv1_1 = BasicConv2d(2 * embed_dim, embed_dim, 1)

    def forward(self, x):
        half = self.local_11conv.in_channels
        local = self.local(self.local_11conv(x[:, :half]))
        glob = self.GlobelBlock(self.global_11conv(x[:, half:]))
        return self.conv1_1(torch.cat([local, glob], dim=1))


class SBA(nn.Module):
    """Selective boundary aggregation of a high-level map `hf` (1/8) and a
    low-level one `lf` (1/4), each gating the other through its sigmoid."""

    def __init__(self, input_dim: int = 32, out_channels: int = 1):
        super().__init__()
        half = input_dim // 2
        self.fc1 = Conv2d(input_dim, half, 1, bias=False)
        self.fc2 = Conv2d(input_dim, half, 1, bias=False)
        self.d_in1 = BasicConv2d(half, half, 1)
        self.d_in2 = BasicConv2d(half, half, 1)
        self.conv = nn.Sequential(BasicConv2d(input_dim, input_dim, 3),
                                  Conv2d(input_dim, out_channels, 1, bias=False))

    def forward(self, hf, lf):
        lf, hf = self.fc1(lf), self.fc2(hf)
        g_l, g_h = torch.sigmoid(lf), torch.sigmoid(hf)
        lf, hf = self.d_in1(lf), self.d_in2(hf)
        lf = lf + lf * g_l + (1 - g_l) * resize(g_h * hf, lf.shape[2:])
        hf = hf + hf * g_h + (1 - g_h) * resize(g_l * lf, hf.shape[2:])  # down: 1/4 -> 1/8
        return self.conv(torch.cat([resize(hf, lf.shape[2:]), lf], dim=1))


class DuAT(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 1, dim: int = 32,
                 dims: Sequence[int] = (64, 128, 320, 512), model_dir: str = "",
                 generator: Optional[torch.Generator] = None):
        """`model_dir` names the reference's pretrained-backbone `.pth` (not in
        the repo): the constructor does not read it; `create_train_state`
        warm-starts the backbone from it (`utils/torch_convert.py::warm_start`),
        as the JAX package's does."""
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.backbone = pvt_v2_b2(g, in_channels)
        self.GLSA_c4 = GLSA(dims[3], dim)
        self.GLSA_c3 = GLSA(dims[2], dim)
        self.GLSA_c2 = GLSA(dims[1], dim)
        self.fuse2 = nn.Sequential(BasicConv2d(3 * dim, dim, 1),
                                   Conv2d(dim, out_channels, 1, bias=False))
        self.L_feature = BasicConv2d(dims[0], dim, 3)
        self.fuse = BasicConv2d(2 * dim, dim, 1)
        self.SBA = SBA(dim, out_channels)
        init_flax_style(self, g)
        for glsa in (self.GLSA_c4, self.GLSA_c3, self.GLSA_c2):  # the reference's last_zero_init
            nn.init.zeros_(glsa.GlobelBlock.channel_mul_conv[3].weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1, c2, c3, c4 = self.backbone(x)
        _c4 = resize(self.GLSA_c4(c4), c3.shape[2:])
        _c3 = self.GLSA_c3(c3)
        _c2 = self.GLSA_c2(c2)
        out1 = self.fuse2(torch.cat([resize(_c4, c2.shape[2:]), resize(_c3, c2.shape[2:]), _c2],
                                    dim=1))
        lf = self.L_feature(c1)
        hf = resize(self.fuse(torch.cat([_c4, _c3], dim=1)), c2.shape[2:])
        out2 = self.SBA(hf, lf)
        out1 = resize(out1, (out1.shape[2] * 8, out1.shape[3] * 8))
        out2 = resize(out2, (out2.shape[2] * 4, out2.shape[3] * 4))
        return out1 + out2
