"""UNETR (2-D) in PyTorch (counterpart of `mm_unet_tpu/models/unetr.py`): a
ViT encoder over 16x16 patches with a learned position embedding, its
hidden states at layers 3, 6 and 9 and the final normed state
deconvolved into 1/2, 1/4 and 1/8 skips, and a UNet-style decoder of
transposed convs and residual conv blocks (InstanceNorm, leaky ReLU).

The position embedding's shape is fixed by `img_size` at construction
(flax takes it from the first input): an input of another size raises a
`ValueError`. `.eval()` and `.train()` compute the same function (no
dropout, no BatchNorm). Parameter names are those of the torch
restatement of MONAI's UNETR that `mm_unet_tpu.utils.torch_convert.
unetr_pairs` tabulates (patch_embed, pos_embed, blocks.0.qkv, blocks.0.out,
blocks.0.fc1, norm, enc1.conv3, enc2.up0, enc2.ups.0.block.norm1,
dec3.deconv, out), so `utils.convert` maps JAX variables onto this model.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    LayerNorm,
    Linear,
    attention,
    init_flax_style,
)


class ViTBlock(nn.Module):
    """Pre-norm multi-head self-attention (fused qkv, rows [q; k; v]) and
    MLP (exact GELU), each added to its input."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(hidden, eps=1e-5)
        self.qkv = Linear(hidden, 3 * hidden)
        self.out = Linear(hidden, hidden)
        self.norm2 = LayerNorm(hidden, eps=1e-5)
        self.fc1 = Linear(hidden, mlp_dim)
        self.fc2 = Linear(mlp_dim, hidden)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(self.norm1(x)).view(b, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        h = attention(q, k, v, hd ** -0.5).transpose(1, 2).reshape(b, n, c)
        x = x + self.out(h)
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class ResBlock(nn.Module):
    """MONAI's UnetResBlock: (3x3 conv, InstanceNorm, leaky ReLU, 3x3 conv,
    InstanceNorm) plus the input (through a 1x1 conv and InstanceNorm when
    the width changes), then leaky ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.norm1 = nn.InstanceNorm2d(out_channels, eps=1e-5, affine=True)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.norm2 = nn.InstanceNorm2d(out_channels, eps=1e-5, affine=True)
        if in_channels != out_channels:
            self.conv3 = Conv2d(in_channels, out_channels, 1, bias=False)
            self.norm3 = nn.InstanceNorm2d(out_channels, eps=1e-5, affine=True)

    def forward(self, x):
        h = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        h = self.norm2(self.conv2(h))
        res = self.norm3(self.conv3(x)) if hasattr(self, "conv3") else x
        return F.leaky_relu(h + res, 0.01)


class PrUpBlock(nn.Module):
    """A 2x2 stride-2 deconv, then `num_layer` x (deconv, ResBlock)."""

    def __init__(self, in_channels: int, out_channels: int, num_layer: int):
        super().__init__()
        self.up0 = ConvTranspose2d(in_channels, out_channels, 2, stride=2)
        self.ups = nn.ModuleList()
        for _ in range(num_layer):
            up = nn.Module()
            up.deconv = ConvTranspose2d(out_channels, out_channels, 2, stride=2)
            up.block = ResBlock(out_channels, out_channels)
            self.ups.append(up)

    def forward(self, x):
        x = self.up0(x)
        for up in self.ups:
            x = up.block(up.deconv(x))
        return x


class UpBlock(nn.Module):
    """A 2x2 stride-2 deconv, then a ResBlock of [x, skip]."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.deconv = ConvTranspose2d(in_channels, out_channels, 2, stride=2)
        self.block = ResBlock(2 * out_channels, out_channels)

    def forward(self, x, skip):
        return self.block(torch.cat([self.deconv(x), skip], dim=1))


class UNETR(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 1, img_size: int = 352,
                 feature_size: int = 64, hidden_size: int = 768, mlp_dim: int = 3072,
                 num_heads: int = 12, num_layers: int = 12, patch_size: int = 16,
                 spatial_dims: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        if spatial_dims != 2:
            raise ValueError(f"UNETR: only spatial_dims=2 is supported, not {spatial_dims}")
        if num_layers < 9:
            raise ValueError(f"UNETR taps layers 3, 6 and 9: num_layers {num_layers} < 9")
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        fs, self.img_size, self.patch_size = feature_size, img_size, patch_size
        tokens = (img_size // patch_size) ** 2
        self.patch_embed = Conv2d(in_channels, hidden_size, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.randn(1, tokens, hidden_size, generator=g) * 0.02)
        self.blocks = nn.ModuleList([ViTBlock(hidden_size, num_heads, mlp_dim)
                                     for _ in range(num_layers)])
        self.norm = LayerNorm(hidden_size, eps=1e-5)
        self.enc1 = ResBlock(in_channels, fs)
        self.enc2 = PrUpBlock(hidden_size, fs * 2, 2)
        self.enc3 = PrUpBlock(hidden_size, fs * 4, 1)
        self.enc4 = PrUpBlock(hidden_size, fs * 8, 0)
        self.dec3 = UpBlock(hidden_size, fs * 8)
        self.dec2 = UpBlock(fs * 8, fs * 4)
        self.dec1 = UpBlock(fs * 4, fs * 2)
        self.dec0 = UpBlock(fs * 2, fs)
        self.out = Conv2d(fs, out_channels, 1)
        init_flax_style(self, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hgt, wdt = x.shape
        if (hgt, wdt) != (self.img_size, self.img_size):
            raise ValueError(f"UNETR was built for {self.img_size}x{self.img_size} inputs (its "
                             f"position embedding); got {hgt}x{wdt}")
        hp, wp = hgt // self.patch_size, wdt // self.patch_size
        t = self.patch_embed(x).flatten(2).transpose(1, 2) + self.pos_embed
        taps = []
        for i, blk in enumerate(self.blocks, start=1):
            t = blk(t)
            if i in (3, 6, 9):
                taps.append(t)
        taps.append(self.norm(t))
        grid = [tap.transpose(1, 2).reshape(b, -1, hp, wp) for tap in taps]
        enc4 = self.enc4(grid[2])
        h = self.dec3(grid[3], enc4)
        h = self.dec2(h, self.enc3(grid[1]))
        h = self.dec1(h, self.enc2(grid[0]))
        return self.out(self.dec0(h, self.enc1(x)))
