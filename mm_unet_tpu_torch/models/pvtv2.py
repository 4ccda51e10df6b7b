"""PVTv2 in PyTorch (counterpart of `mm_unet_tpu/models/pvtv2.py`), the
backbone of FCBFormer, DuAT, PVT_CASCADE, CVC_UNETR and BMANet: four
stages, each an overlapping patch embedding (a strided conv and
LayerNorm), blocks of spatial-reduction attention and a Mix-FFN (Linear,
3x3 depthwise conv, exact GELU, Linear), and a LayerNorm (eps 1e-6
throughout). Returns the four NCHW maps at 1/4, 1/8, 1/16 and 1/32.

The stages' modules are children in the reference's order (patch_embed1,
block1, norm1, patch_embed2, ...), so FCBFormer can flatten them into a
Sequential as the reference does (`models.py:129`), and `pyramid` runs
either form. Parameter names are the reference's (`pvt_v2.py`:
patch_embed1.proj, block1.0.attn.q, block1.0.attn.sr, block1.0.mlp.dwconv.dwconv,
norm1), as `mm_unet_tpu.utils.torch_convert.pvtv2_pairs` tabulates them.
`pvt_v2_b2` (DuAT, PVT_CASCADE, BMANet) and `pvt_v2_b3` (FCBFormer) load
no `.pth`: the zoo starts from random weights, as the JAX package does
without the file.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import (
    Conv2d,
    DropPath,
    LayerNorm,
    Linear,
    attention,
    init_flax_style,
)


def _grid(x: torch.Tensor, hgt: int, wdt: int) -> torch.Tensor:
    """Tokens (B, H*W, C) -> NCHW map."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], hgt, wdt)


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x, hgt, wdt):
        return self.dwconv(_grid(x, hgt, wdt)).flatten(2).transpose(1, 2)


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x, hgt, wdt):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), hgt, wdt)))


class SRAttention(nn.Module):
    """Attention whose keys and values come from the map reduced by an
    sr x sr stride-sr conv and a LayerNorm (sr > 1)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = LayerNorm(dim, eps=1e-6)

    def forward(self, x, hgt, wdt):
        b, n, c = x.shape
        h, hd = self.num_heads, c // self.num_heads
        q = self.q(x).view(b, n, h, hd).transpose(1, 2)
        if self.sr_ratio > 1:
            x = self.norm(self.sr(_grid(x, hgt, wdt)).flatten(2).transpose(1, 2))
        k, v = self.kv(x).view(b, -1, 2, h, hd).permute(2, 0, 3, 1, 4)
        return self.proj(attention(q, k, v, hd ** -0.5).transpose(1, 2).reshape(b, n, c))


class PVTBlock(nn.Module):
    """x + drop_path(attn(norm1(x))), then + mlp(norm2(x)): the JAX block
    drops only the attention branch."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, sr_ratio: int,
                 drop_path: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = SRAttention(dim, num_heads, sr_ratio)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio))

    def forward(self, x, hgt, wdt):
        x = x + self.drop_path(self.attn(self.norm1(x), hgt, wdt))
        return x + self.mlp(self.norm2(x), hgt, wdt)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = Conv2d(in_channels, dim, patch, stride=stride, padding=patch // 2)
        self.norm = LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        x = self.proj(x)
        return self.norm(x.flatten(2).transpose(1, 2)), x.shape[2], x.shape[3]


def pyramid(stages: Sequence[nn.Module], x: torch.Tensor) -> list:
    """The four NCHW maps of a PVTv2 whose modules `stages` lists as
    (patch embedding, blocks, norm) four times."""
    out = []
    for i in range(0, len(stages), 3):
        embed, blocks, norm = stages[i:i + 3]
        h, hgt, wdt = embed(x)
        for blk in blocks:
            h = blk(h, hgt, wdt)
        x = _grid(norm(h), hgt, wdt)
        out.append(x)
    return out


class PVTv2(nn.Module):
    """b2: depths (3, 4, 6, 3); b3: (3, 4, 18, 3)."""

    def __init__(self, in_channels: int = 3, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 mlp_ratios: Sequence[float] = (8, 8, 4, 4), depths: Sequence[int] = (3, 4, 6, 3),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cin = in_channels
        for i in range(4):
            self.add_module(f"patch_embed{i + 1}", OverlapPatchEmbed(
                cin, embed_dims[i], 7 if i == 0 else 3, 4 if i == 0 else 2))
            self.add_module(f"block{i + 1}", nn.ModuleList([
                PVTBlock(embed_dims[i], num_heads[i], mlp_ratios[i], sr_ratios[i])
                for _ in range(depths[i])]))
            self.add_module(f"norm{i + 1}", LayerNorm(embed_dims[i], eps=1e-6))
            cin = embed_dims[i]
        init_flax_style(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> list:
        return pyramid(list(self.children()), x)


def pvt_v2_b2(generator: Optional[torch.Generator] = None, in_channels: int = 3) -> PVTv2:
    return PVTv2(in_channels, depths=(3, 4, 6, 3), generator=generator)


def pvt_v2_b3(generator: Optional[torch.Generator] = None) -> PVTv2:
    return PVTv2(depths=(3, 4, 18, 3), generator=generator)
