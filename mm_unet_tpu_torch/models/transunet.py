"""TransUNet in PyTorch (counterpart of `mm_unet_tpu/models/transunet.py`):
a 7x7 stride-2 conv stem, three bottleneck encoders (stride 2 each), a
ViT with a class token over the 1/16 map's pixels, a 3x3 conv to 512, and
a decoder of bilinear (align-corners) x2 upsamplings, each concatenated
after its skip and followed by two 3x3 conv / BatchNorm / ReLU.

Kept from the reference: the attention multiplies q·kᵀ by sqrt(d_head)
instead of dividing (`TransUnet.py:12,21`), and the fused qkv features
split as (d k h), d slowest. Pinned to the reference where the JAX module
differs (ROADMAP.md, queue 3): LayerNorm eps 1e-5 (flax's default is
1e-6) and the exact GELU (flax's default is the tanh form).

The ViT's position embedding has one row per token of the 1/16 map plus
the class token, so `img_dim` fixes the input size at construction (flax
takes it from the first input): an input of another size raises a
`ValueError`. `.train()` normalises with the batch statistics and draws the
four Dropout(0.1) sites' masks (the embedding's, and the attention's, the
MLP's middle and its output in each block) from the generator that
`set_dropout_generator` sets. Module and parameter names are the torch
reference's (`src/TransUnet/TransUnet.py`), as
`mm_unet_tpu.utils.torch_convert.transunet_pairs` tabulates them
(encoder.conv1, encoder.encoder1.downsample.0, encoder.vit.embedding,
encoder.vit.transformer.layer_blocks.0.multi_head_attention.qkv_layer,
decoder.decoder1.layer.0, decoder.conv1), so `utils.convert` maps JAX
variables onto this model.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    Dropout,
    LayerNorm,
    Linear,
    attention,
    init_flax_style,
    resize_bilinear_align_corners,
)


class MultiHeadAttention(nn.Module):
    def __init__(self, embedding_dim: int, head_num: int):
        super().__init__()
        self.head_num = head_num
        self.qkv_layer = Linear(embedding_dim, 3 * embedding_dim, bias=False)
        self.out_attention = Linear(embedding_dim, embedding_dim, bias=False)

    def forward(self, x):
        b, t, e = x.shape
        h, d = self.head_num, e // self.head_num
        q, k, v = self.qkv_layer(x).view(b, t, d, 3, h).permute(3, 0, 4, 1, 2)
        out = attention(q, k, v, d ** 0.5)  # the reference's sqrt(d) product
        return self.out_attention(out.transpose(1, 2).reshape(b, t, e))


class MLP(nn.Module):
    def __init__(self, embedding_dim: int, mlp_dim: int):
        super().__init__()
        self.mlp_layers = nn.Sequential(Linear(embedding_dim, mlp_dim), nn.GELU(), Dropout(0.1),
                                        Linear(mlp_dim, embedding_dim), Dropout(0.1))

    def forward(self, x):
        return self.mlp_layers(x)


class TransformerEncoderBlock(nn.Module):
    """Post-norm: LN(x + dropout(attention(x))), then LN(x + mlp(x))."""

    def __init__(self, embedding_dim: int, head_num: int, mlp_dim: int):
        super().__init__()
        self.multi_head_attention = MultiHeadAttention(embedding_dim, head_num)
        self.dropout = Dropout(0.1)
        self.layer_norm1 = LayerNorm(embedding_dim, eps=1e-5)
        self.mlp = MLP(embedding_dim, mlp_dim)
        self.layer_norm2 = LayerNorm(embedding_dim, eps=1e-5)

    def forward(self, x):
        x = self.layer_norm1(x + self.dropout(self.multi_head_attention(x)))
        return self.layer_norm2(x + self.mlp(x))


class ViT(nn.Module):
    """Patch-1 ViT over an NCHW map: its pixels as tokens (row-major), a
    class token in front, the learned embedding added, dropout, the blocks;
    returns the pixels' tokens."""

    def __init__(self, tokens: int, in_channels: int, embedding_dim: int, head_num: int,
                 mlp_dim: int, block_num: int, generator: torch.Generator):
        super().__init__()
        self.projection = Linear(in_channels, embedding_dim)
        self.cls_token = nn.Parameter(torch.randn(1, 1, embedding_dim, generator=generator))
        self.embedding = nn.Parameter(torch.rand(tokens + 1, embedding_dim, generator=generator))
        self.dropout = Dropout(0.1)
        self.transformer = nn.Module()
        self.transformer.layer_blocks = nn.ModuleList(
            [TransformerEncoderBlock(embedding_dim, head_num, mlp_dim) for _ in range(block_num)])

    def forward(self, x):
        tokens = self.projection(x.flatten(2).transpose(1, 2))
        h = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), tokens], dim=1)
        h = self.dropout(h + self.embedding)
        for blk in self.transformer.layer_blocks:
            h = blk(h)
        return h[:, 1:]


class EncoderBottleneck(nn.Module):
    """1x1, 3x3 stride 2, 1x1 convs with BatchNorm (ReLU after the first
    two), plus a strided 1x1 projection of the input, then ReLU."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2,
                 base_width: int = 64):
        super().__init__()
        width = int(out_channels * (base_width / 64))
        self.downsample = nn.Sequential(
            Conv2d(in_channels, out_channels, 1, stride=stride, bias=False),
            BatchNorm2d(out_channels))
        self.conv1 = Conv2d(in_channels, width, 1, bias=False)
        self.norm1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride=2, padding=1, bias=False)
        self.norm2 = BatchNorm2d(width)
        self.conv3 = Conv2d(width, out_channels, 1, bias=False)
        self.norm3 = BatchNorm2d(out_channels)

    def forward(self, x):
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        return F.relu(self.norm3(self.conv3(h)) + self.downsample(x))


class DecoderBottleneck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.layer = nn.Sequential(
            Conv2d(in_channels, out_channels, 3, padding=1), BatchNorm2d(out_channels), nn.ReLU(),
            Conv2d(out_channels, out_channels, 3, padding=1), BatchNorm2d(out_channels),
            nn.ReLU())

    def forward(self, x, skip=None):
        x = resize_bilinear_align_corners(x, (x.shape[2] * self.scale, x.shape[3] * self.scale))
        if skip is not None:
            x = torch.cat([skip, x], dim=1)
        return self.layer(x)


class TransUNet(nn.Module):
    def __init__(self, img_dim: int = 352, in_channels: int = 3, out_channels: int = 128,
                 head_num: int = 4, mlp_dim: int = 512, block_num: int = 8,
                 patch_dim: int = 16, class_num: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        oc, self.img_dim = out_channels, img_dim
        self.encoder = nn.Module()
        self.encoder.conv1 = Conv2d(in_channels, oc, 7, stride=2, padding=3, bias=False)
        self.encoder.norm1 = BatchNorm2d(oc)
        self.encoder.encoder1 = EncoderBottleneck(oc, oc * 2)
        self.encoder.encoder2 = EncoderBottleneck(oc * 2, oc * 4)
        self.encoder.encoder3 = EncoderBottleneck(oc * 4, oc * 8)
        self.encoder.vit = ViT((img_dim // patch_dim) ** 2, oc * 8, oc * 8, head_num, mlp_dim,
                               block_num, g)
        self.encoder.conv2 = Conv2d(oc * 8, 512, 3, padding=1)
        self.encoder.norm2 = BatchNorm2d(512)
        self.decoder = nn.Module()
        self.decoder.decoder1 = DecoderBottleneck(512 + oc * 4, oc * 2)
        self.decoder.decoder2 = DecoderBottleneck(oc * 4, oc)
        self.decoder.decoder3 = DecoderBottleneck(oc * 2, oc // 2)
        self.decoder.decoder4 = DecoderBottleneck(oc // 2, oc // 8)
        self.decoder.conv1 = Conv2d(oc // 8, class_num, 1)
        init_flax_style(self, g)

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw every Dropout mask from `generator` (on the model's device)."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[2:]) != (self.img_dim, self.img_dim):
            raise ValueError(f"TransUNet was built for {self.img_dim}x{self.img_dim} inputs (its "
                             f"ViT's embedding); got {x.shape[2]}x{x.shape[3]}")
        enc = self.encoder
        x1 = F.relu(enc.norm1(enc.conv1(x)))
        x2 = enc.encoder1(x1)
        x3 = enc.encoder2(x2)
        h = enc.encoder3(x3)
        b, c, hh, ww = h.shape
        h = enc.vit(h).transpose(1, 2).reshape(b, c, hh, ww)
        h = F.relu(enc.norm2(enc.conv2(h)))
        dec = self.decoder
        h = dec.decoder1(h, x3)
        h = dec.decoder2(h, x2)
        h = dec.decoder3(h, x1)
        return dec.conv1(dec.decoder4(h))
