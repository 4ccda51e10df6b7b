"""VANet in PyTorch (counterpart of `mm_unet_tpu/models/vanet.py`): a CvT
encoder (convolutional patch embeddings, attention whose q, k, v come from
depthwise conv + BatchNorm projections, k and v at stride 2) turned
U-shaped: the second half of CvT stage 2 and two PatchExpand stages decode,
each block's attention guided by the previous stage's mask, and four mask
heads; the last one's sigmoid is bilinearly upsampled (align_corners=True)
to the input size, so the model emits probabilities.

Mask-guided attention (blocks that receive a mask r): the attention
weights are multiplied by alpha times |r_q r_kvᵀ| + 1 normalised by its
row maximum, r resized (bilinear, half-pixel centres, no antialiasing, as
the reference's `F.interpolate`, also when it shrinks) to the queries' and
the keys' grids. `alpha` exists only on those blocks. The MLPs use
quick_gelu, x sigmoid(1.702 x); the scale is dim^-1/2 (CvT's).

Dropout (after the MLP's layers and the output projection), attention
dropout and stochastic depth on both residual branches are at the JAX
model's rates (0.1 each; drop path linear over each encoder stage's
depth, 0.1 in the freshly built decoder blocks); `.eval()` makes them the
identity, and `set_dropout_generator` sets their masks' generator.

Activations between blocks are tokens (B, H W, C) with their grid's (H,
W). Module and parameter names are the torch reference's, as
`mm_unet_tpu.utils.torch_convert.vanet_pairs` tabulates them
(encoder_stage0/1, encoder_stage2_merge, encoder_stage2_blk,
decoder_stage0_blk, decoder_stage1/2_expand and _blk, mask_head0-3).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    DropPath,
    Dropout,
    LayerNorm,
    Linear,
    init_flax_style,
    resize_bilinear_align_corners,
    resize_bilinear_torch,
)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _grid(x: torch.Tensor, hgt: int, wdt: int) -> torch.Tensor:
    """Tokens (B, H*W, C) -> NCHW map."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], hgt, wdt)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


class ConvProj(nn.Module):
    """3x3 depthwise conv (stride s, no bias) + BatchNorm (CvT's 'dw_bn')."""

    def __init__(self, dim: int, stride: int = 1):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3, stride=stride, padding=1, groups=dim, bias=False)
        self.bn = BatchNorm2d(dim)

    def forward(self, x):
        return self.bn(self.conv(x))


class CvTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, stride_kv: int = 1, pool_kv: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, qkv_bias: bool = True,
                 guided: bool = False):
        """`pool_kv` 3x3 stride-2 average-pools k and v (padding 1, the pad
        counted in the mean); `guided` blocks take a mask and own `alpha`."""
        super().__init__()
        self.num_heads, self.pool_kv, self.dim = num_heads, pool_kv, dim
        self.conv_proj_q = ConvProj(dim, 1)
        self.conv_proj_k = ConvProj(dim, stride_kv)
        self.conv_proj_v = ConvProj(dim, stride_kv)
        self.proj_q = Linear(dim, dim, bias=qkv_bias)
        self.proj_k = Linear(dim, dim, bias=qkv_bias)
        self.proj_v = Linear(dim, dim, bias=qkv_bias)
        self.attn_drop = Dropout(attn_drop)
        self.proj = Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)
        if guided:
            self.alpha = nn.Parameter(torch.ones(()))

    def forward(self, x, hgt, wdt, r=None):
        b, n, c = x.shape
        nh, hd = self.num_heads, self.dim // self.num_heads
        m = _grid(x, hgt, wdt)
        q, k, v = self.conv_proj_q(m), self.conv_proj_k(m), self.conv_proj_v(m)
        if self.pool_kv:
            k, v = (F.avg_pool2d(t, 3, 2, 1) for t in (k, v))
        hk, wk = k.shape[2:]
        q = self.proj_q(_tokens(q)).view(b, n, nh, hd).transpose(1, 2)
        k = self.proj_k(_tokens(k)).view(b, -1, nh, hd).transpose(1, 2)
        v = self.proj_v(_tokens(v)).view(b, -1, nh, hd).transpose(1, 2)
        att = (torch.matmul(q, k.transpose(-2, -1)) * self.dim ** -0.5).softmax(dim=-1)
        if r is not None:
            r0 = _tokens(resize_bilinear_torch(r, (hgt, wdt)))
            r1 = _tokens(resize_bilinear_torch(r, (hk, wk)))
            guide = torch.matmul(r0, r1.transpose(1, 2)).abs()[:, None] + 1.0
            att = self.alpha * (guide / guide.amax(dim=3, keepdim=True)) * att
        out = torch.matmul(self.attn_drop(att), v).transpose(1, 2).reshape(b, n, self.dim)
        return self.proj_drop(self.proj(out))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, drop: float):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.drop1, self.drop2 = Dropout(drop), Dropout(drop)

    def forward(self, x):
        return self.drop2(self.fc2(self.drop1(quick_gelu(self.fc1(x)))))


class CvTBlock(nn.Module):
    """x + drop_path(attn(LN(x))), then + drop_path(mlp(LN(x)))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, stride_kv: int = 1,
                 pool_kv: bool = False, mlp_drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, qkv_bias: bool = True, guided: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = CvTAttention(dim, num_heads, stride_kv, pool_kv, attn_drop, mlp_drop,
                                 qkv_bias, guided)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), mlp_drop)

    def forward(self, x, hgt, wdt, r=None):
        x = x + self.drop_path(self.attn(self.norm1(x), hgt, wdt, r))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerge(nn.Module):
    """p x p conv at stride s (padding 2 for the 7x7 stem, else s // 2),
    to tokens, LayerNorm."""

    def __init__(self, in_channels: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = Conv2d(in_channels, dim, patch, stride=stride,
                           padding=2 if patch == 7 else stride // 2)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        x = self.proj(x)
        return self.norm(_tokens(x)), x.shape[2], x.shape[3]


class PatchExpand(nn.Module):
    """x1 bilinearly upsampled ×s (half-pixel centres), concatenated with
    x2, a p x p conv (padding p // 2), to tokens, LayerNorm."""

    def __init__(self, in_channels: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.stride = stride
        self.proj = Conv2d(in_channels, dim, patch, padding=patch // 2)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x1, x2):
        x1 = F.interpolate(x1, scale_factor=self.stride, mode="bilinear", align_corners=False)
        x = self.proj(torch.cat([x1, x2], dim=1))
        return self.norm(_tokens(x)), x.shape[2], x.shape[3]


class VANet(nn.Module):
    def __init__(self, cfg: str = "", embed_dims: Sequence[int] = (64, 192, 384),
                 depths: Sequence[int] = (1, 2, 10), mlp_ratios: Sequence[float] = (4, 4, 4),
                 num_heads: Sequence[int] = (1, 3, 6), strides: Sequence[int] = (4, 2, 2),
                 proj_drop: float = 0.1, attn_drop: float = 0.1, drop_path: float = 0.1,
                 num_class: int = 1, generator: Optional[torch.Generator] = None):
        """`cfg` (the reference's yacs config path) is accepted and unused:
        the widths come as arguments, as in the JAX model."""
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        dims, heads, mr = embed_dims, num_heads, mlp_ratios
        half = depths[2] // 2

        def dpr(stage, j):  # stochastic depth linear over an encoder stage
            d = depths[stage]
            return drop_path * j / (d - 1) if d > 1 else 0.0

        self.encoder_stage0 = nn.Module()
        self.encoder_stage0.patch_embed = PatchMerge(3, dims[0], 7, strides[0])
        self.encoder_stage0.blocks = nn.ModuleList([
            CvTBlock(dims[0], heads[0], mr[0], 2, mlp_drop=proj_drop, attn_drop=attn_drop,
                     drop_path=dpr(0, j)) for j in range(depths[0])])
        self.encoder_stage1 = nn.Module()
        self.encoder_stage1.patch_embed = PatchMerge(dims[0], dims[1], 3, strides[1])
        self.encoder_stage1.blocks = nn.ModuleList([
            CvTBlock(dims[1], heads[1], mr[1], 2, mlp_drop=proj_drop, attn_drop=attn_drop,
                     drop_path=dpr(1, j)) for j in range(depths[1])])
        self.encoder_stage2_merge = PatchMerge(dims[1], dims[2], 3, strides[2])
        self.encoder_stage2_blk = nn.ModuleList([
            CvTBlock(dims[2], heads[2], mr[2], 1 if i % 2 else 2, pool_kv=i % 2 == 1,
                     mlp_drop=proj_drop, attn_drop=attn_drop, drop_path=dpr(2, i))
            for i in range(half)])
        self.mask_head0 = Conv2d(dims[2], num_class, 3, padding=1)
        self.decoder_stage0_blk = nn.ModuleList([
            CvTBlock(dims[2], heads[2], mr[2], 2, mlp_drop=proj_drop, attn_drop=attn_drop,
                     drop_path=dpr(2, half + j), guided=True)
            for j in range(depths[2] - half)])
        self.mask_head1 = Conv2d(dims[2], num_class, 3, padding=1)
        self.decoder_stage1_expand = PatchExpand(dims[2] + dims[1], dims[1],
                                                 2 * strides[2] - 1, strides[2])
        self.decoder_stage1_blk = nn.ModuleList([
            CvTBlock(dims[1], heads[1], mr[1], 2, mlp_drop=proj_drop, attn_drop=attn_drop,
                     drop_path=drop_path, qkv_bias=False, guided=True)
            for _ in range(depths[1])])
        self.mask_head2 = Conv2d(dims[1], num_class, 3, padding=1)
        self.decoder_stage2_expand = PatchExpand(dims[1] + dims[0], dims[0],
                                                 2 * strides[1] - 1, strides[1])
        self.decoder_stage2_blk = nn.ModuleList([
            CvTBlock(dims[0], heads[0], mr[0], 2, mlp_drop=proj_drop, attn_drop=attn_drop,
                     drop_path=drop_path, qkv_bias=False, guided=True)
            for _ in range(depths[0])])
        self.mask_head3 = Conv2d(dims[0], num_class, 3, padding=1)
        init_flax_style(self, g)

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw every Dropout and DropPath mask from `generator` (on the
        model's device)."""
        for m in self.modules():
            if isinstance(m, (Dropout, DropPath)):
                m.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_hw = x.shape[2:]

        def run(blks, f, hw, r=None):
            for blk in blks:
                f = blk(f, *hw, r)
            return f

        f0, *hw0 = self.encoder_stage0.patch_embed(x)
        f0 = run(self.encoder_stage0.blocks, f0, hw0)
        f1, *hw1 = self.encoder_stage1.patch_embed(_grid(f0, *hw0))
        f1 = run(self.encoder_stage1.blocks, f1, hw1)
        f, *hw2 = self.encoder_stage2_merge(_grid(f1, *hw1))
        f = run(self.encoder_stage2_blk, f, hw2)
        out0 = self.mask_head0(_grid(f, *hw2))
        f = run(self.decoder_stage0_blk, f, hw2, out0)
        out1 = self.mask_head1(_grid(f, *hw2))
        f, *hw = self.decoder_stage1_expand(_grid(f, *hw2), _grid(f1, *hw1))
        f = run(self.decoder_stage1_blk, f, hw, out1)
        out2 = self.mask_head2(_grid(f, *hw))
        f, *hw = self.decoder_stage2_expand(_grid(f, *hw), _grid(f0, *hw0))
        f = run(self.decoder_stage2_blk, f, hw, out2)
        out3 = self.mask_head3(_grid(f, *hw))
        return resize_bilinear_align_corners(torch.sigmoid(out3), in_hw)
