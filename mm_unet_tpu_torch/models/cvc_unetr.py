"""CVC_UNETR in PyTorch (counterpart of `mm_unet_tpu/models/cvc_unetr.py`,
class `CVC_Unetr`, registered as CVC_UNETR): a PVTv2-b2 encoder, attention
blocks on its three deeper maps (a global branch of conv, GroupNorm,
re-parameterisable depthwise convs and a pointwise MLP on one half of the
channels, a local branch of BatchNorm and depthwise-separable convs on the
other), a fuse head at 1/8, and a head at 1/4 through a sparse global
transformer (the map subsampled by 4, an attention over its pixels with no
1/sqrt(d) scale) and a local reverse diffusion (a depthwise 4x4 stride-4
transposed conv back to 1/4, GroupNorm(1), a 1x1 conv). The two heads are
bilinearly upsampled (half-pixel centres) to the input size and summed.

GroupNorms run at eps 1e-5; GELUs are exact (the shallow block) and the
deep blocks use SiLU. Module and parameter names are the torch reference's,
as `mm_unet_tpu.utils.torch_convert.cvc_unetr_pairs` tabulates them
(backbone; block4/3/2 with gobel_attention, local_attention, downsample;
fuse2, L_feature, fuse; g.qkv; l.conv_trans, l.norm, l.pointwise_conv).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    GroupNorm,
    attention,
    init_flax_style,
    resize_linear,
)
from mm_unet_tpu_torch.models.pvtv2 import PVTv2

_ACTS = {"relu": nn.ReLU, "gelu": nn.GELU, "silu": nn.SiLU}


class BasicConv2d(nn.Module):
    """k x k conv (no bias, padding k // 2), BatchNorm, `act`."""

    def __init__(self, in_planes: int, out_planes: int, kernel: int = 1, act: str = "relu"):
        super().__init__()
        self.conv = Conv2d(in_planes, out_planes, kernel, padding=kernel // 2, bias=False)
        self.bn = BatchNorm2d(out_planes)
        self.act = _ACTS[act]()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str):
        super().__init__()
        self.line_conv_0 = Conv2d(dim, hidden, 1, bias=False)
        self.act = _ACTS[act]()
        self.line_conv_1 = Conv2d(hidden, dim, 1, bias=False)

    def forward(self, x):
        return self.line_conv_1(self.act(self.line_conv_0(x)))


class GobleAttention(nn.Module):
    """3x3 conv, GroupNorm(out / 2), `act`; then the sum of a k x k
    depthwise conv + BN, a 1x1 depthwise conv + BN and the input; an MLP of
    two 1x1 convs; plus the post-activation map."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 3, mlp_ratio: int = 4,
                 act: str = "gelu"):
        super().__init__()
        od, k = out_dim, kernel_size
        self.conv = Conv2d(in_dim, od, 3, padding=1)
        self.norm = GroupNorm(od // 2, od)
        self.act = _ACTS[act]()
        self.base_conv = Conv2d(od, od, k, padding=k // 2, groups=od, bias=False)
        self.base_norm = BatchNorm2d(od)
        self.add_conv = Conv2d(od, od, 1, groups=od, bias=False)
        self.add_norm = BatchNorm2d(od)
        self.mlp = MLP(od, od * mlp_ratio, act)

    def forward(self, x):
        x = self.act(self.norm(self.conv(x)))
        h = self.base_norm(self.base_conv(x)) + self.add_norm(self.add_conv(x)) + x
        return self.mlp(h) + x


class LocalAttention(nn.Module):
    """BN, 1x1 conv, 3x3 depthwise conv, BN, 1x1 conv to `out_dim`."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.bn1 = BatchNorm2d(in_dim)
        self.pointwise_conv_0 = Conv2d(in_dim, in_dim, 1, bias=False)
        self.depthwise_conv = Conv2d(in_dim, in_dim, 3, padding=1, groups=in_dim, bias=False)
        self.bn2 = BatchNorm2d(in_dim)
        self.pointwise_conv_1 = Conv2d(in_dim, out_dim, 1, bias=False)

    def forward(self, x):
        x = self.depthwise_conv(self.pointwise_conv_0(self.bn1(x)))
        return self.pointwise_conv_1(self.bn2(x))


class AttentionBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 3, mlp_ratio: int = 4,
                 shallow: bool = True):
        super().__init__()
        act = "gelu" if shallow else "silu"
        half = in_dim // 2
        self.gobel_attention = GobleAttention(half, out_dim, kernel_size, mlp_ratio, act)
        self.local_attention = LocalAttention(in_dim - half, out_dim)
        self.downsample = BasicConv2d(2 * out_dim, out_dim, 1, act)

    def forward(self, x):
        half = self.gobel_attention.conv.in_channels
        return self.downsample(torch.cat([self.gobel_attention(x[:, :half]),
                                          self.local_attention(x[:, half:])], dim=1))


class GlobalSparseTransformer(nn.Module):
    """Every r-th pixel, a bias-free 1x1 conv to q, k, v (head-major channel
    layout: head h's q, k, v are channels [3 h d, 3 h d + 3 d)), and an
    attention over the pixels without scale; returns the subsampled map."""

    def __init__(self, channels: int, r: int = 4, heads: int = 2):
        super().__init__()
        self.r, self.heads = r, heads
        self.qkv = Conv2d(channels, 3 * channels, 1, bias=False)

    def forward(self, x):
        x = x[:, :, ::self.r, ::self.r]
        b, c, h, w = x.shape
        q, k, v = self.qkv(x).reshape(b, self.heads, 3, c // self.heads, h * w).transpose(
            -2, -1).unbind(2)
        return attention(q, k, v, 1.0).transpose(-2, -1).reshape(b, c, h, w)


class LocalReverseDiffusion(nn.Module):
    """Depthwise r x r stride-r transposed conv (each pixel paints an r x r
    block with its channel's kernel), GroupNorm(1), bias-free 1x1 conv."""

    def __init__(self, in_channels: int, out_channels: int, r: int = 4):
        super().__init__()
        self.conv_trans = ConvTranspose2d(in_channels, in_channels, r, stride=r,
                                          groups=in_channels)
        self.norm = GroupNorm(1, in_channels)
        self.pointwise_conv = Conv2d(in_channels, out_channels, 1, bias=False)

    def forward(self, x):
        return self.pointwise_conv(self.norm(self.conv_trans(x)))


class CVC_Unetr(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 dims: Sequence[int] = (64, 128, 320, 512), out_dim: int = 32,
                 kernel_size: int = 3, mlp_ratio: int = 4, model_dir: str = "",
                 generator: Optional[torch.Generator] = None):
        """`model_dir` (the reference's pretrained-backbone `.pth`, not in the
        repo) is accepted and unused, as in the JAX model."""
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        od = out_dim
        self.backbone = PVTv2(in_channels, embed_dims=dims, generator=g)
        self.block4 = AttentionBlock(dims[3], od, kernel_size, mlp_ratio, False)
        self.block3 = AttentionBlock(dims[2], od, kernel_size, mlp_ratio, False)
        self.block2 = AttentionBlock(dims[1], od, kernel_size, mlp_ratio, True)
        self.fuse2 = nn.Sequential(BasicConv2d(2 * od, od, 1),
                                   Conv2d(od, out_channels, 1, bias=False))
        self.L_feature = BasicConv2d(dims[0], od, 3)
        self.fuse = BasicConv2d(od, od, 1)
        self.g = GlobalSparseTransformer(2 * od)
        self.l = LocalReverseDiffusion(2 * od, out_channels)  # noqa: E741
        init_flax_style(self, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1, c2, c3, c4 = self.backbone(x)
        _c4 = resize_linear(self.block4(c4), c3.shape[2:])
        _c3 = self.block3(c3)
        _c2 = self.block2(c2)
        out1 = self.fuse2(torch.cat([resize_linear(_c4, c2.shape[2:]),
                                     resize_linear(_c3, c2.shape[2:])], dim=1))
        lf = self.L_feature(c1)
        hf = resize_linear(self.fuse(_c2), lf.shape[2:])
        out2 = self.l(self.g(torch.cat([hf, lf], dim=1)))
        out1 = resize_linear(out1, (out1.shape[2] * 8, out1.shape[3] * 8))
        out2 = resize_linear(out2, (out2.shape[2] * 4, out2.shape[3] * 4))
        return out1 + out2
