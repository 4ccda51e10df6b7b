"""SwinUNETR (2-D) in PyTorch (counterpart of
`mm_unet_tpu/models/swin_unetr.py`): a 2x2 patch embedding, four stages of
shifted-window attention (window 7, relative position bias, cyclic shift
with group masks) each ending in patch merging, and MONAI's five-skip
UNETR decoder of residual conv blocks and transposed convs.

A map that is not a multiple of the window is padded to one, and its pads
form a group of their own that no real token attends to; a block shifts
only where the padded map is larger than the window. Each block builds
its mask once per (height, width, device, dtype) and keeps it. With
`use_checkpoint` (flax's `nn.remat` in the JAX model) a train-mode block
recomputes its activations in the backward pass
(`torch.utils.checkpoint`, non-reentrant). `.eval()` and `.train()`
compute the same function. Parameter names are those of the torch
restatement that `mm_unet_tpu.utils.torch_convert.swin_unetr_pairs`
tabulates (patch_embed, stages.0.blocks.0.attn.qkv,
stages.0.blocks.0.attn.rel_pos_bias, stages.0.norm, stages.0.reduction,
enc0.conv3, skip3, up0.deconv, out), so `utils.convert` maps JAX variables
onto this model. (The JAX module names its blocks `CheckpointSwinBlock_i`
when `use_checkpoint` is on, where the table says `SwinBlock_i`.)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mm_unet_tpu_torch.models.layers import (
    Conv2d,
    LayerNorm,
    Linear,
    attention,
    init_flax_style,
)
from mm_unet_tpu_torch.models.unetr import ResBlock, UpBlock


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, windows, ws * ws, C), windows row-major."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // ws) * (w // ws), ws * ws, c)


def _window_reverse(wins: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b, c = wins.shape[0], wins.shape[-1]
    x = wins.view(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _group_mask(hgt: int, wdt: int, ws: int, shift: int) -> np.ndarray:
    """(windows, ws², ws²) additive mask, -1e9 between tokens of different
    groups: the shifted map's three bands each way, and the padded rows
    and columns, each a group of their own."""
    hp, wp = hgt + (-hgt) % ws, wdt + (-wdt) % ws
    img = np.zeros((hp, wp), np.float32)
    bands = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)) if shift else (slice(None),)
    cnt = 0
    for hs in bands:
        for wsl in bands:
            img[hs, wsl] = cnt
            cnt += 1
    img[hgt:, :] = cnt + 1
    img[:, wdt:] = cnt + 2
    groups = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(groups[:, None, :] != groups[:, :, None], -1e9, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, generator: torch.Generator):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos_bias = nn.Parameter(
            torch.randn((2 * window - 1) ** 2, heads, generator=generator) * 0.02)
        coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
        flat = coords.reshape(2, -1)
        rel = flat[:, :, None] - flat[:, None, :] + window - 1
        idx = rel[0] * (2 * window - 1) + rel[1]
        self.register_buffer("rel_idx", torch.from_numpy(idx.reshape(-1)), persistent=False)

    def forward(self, x, mask=None):
        """x (B, windows, n, C); mask (windows, n, n) or None."""
        b, nw, n, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).view(b, nw, n, 3, self.heads, hd).permute(3, 0, 1, 4, 2, 5)
        bias = self.rel_pos_bias[self.rel_idx].view(n, n, self.heads).permute(2, 0, 1)
        out = attention(qkv[0], qkv[1], qkv[2], hd ** -0.5, bias,
                        None if mask is None else mask[:, None])
        return self.proj(out.transpose(2, 3).reshape(b, nw, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 generator: torch.Generator, mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, heads, window, generator)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.fc1 = Linear(dim, int(dim * mlp_ratio))
        self.fc2 = Linear(int(dim * mlp_ratio), dim)
        self._masks: dict = {}

    def _mask(self, hgt: int, wdt: int, shift: int, like: torch.Tensor) -> torch.Tensor:
        key = (hgt, wdt, shift, like.device, like.dtype)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(_group_mask(hgt, wdt, self.window, shift)).to(
                like.device, like.dtype)
        return self._masks[key]

    def forward(self, x):
        """x (B, H, W, C)."""
        b, hgt, wdt, c = x.shape
        ws = self.window
        pad_h, pad_w = (-hgt) % ws, (-wdt) % ws
        h = F.pad(self.norm1(x), (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = hgt + pad_h, wdt + pad_w
        shift = self.shift if min(hp, wp) > ws else 0
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        mask = self._mask(hgt, wdt, shift, h) if (shift or pad_h or pad_w) else None
        h = _window_reverse(self.attn(_window_partition(h, ws), mask), ws, hp, wp)
        if shift:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + h[:, :hgt, :wdt]
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class Stage(nn.Module):
    """Swin blocks (unshifted, shifted, ...), then patch merging: the 2x2
    neighbours concatenated (padded to even), LayerNorm, Linear to 2C."""

    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 generator: torch.Generator):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, window, 0 if j % 2 == 0 else window // 2, generator)
            for j in range(depth)])
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        self.use_checkpoint = False

    def forward(self, x):
        for blk in self.blocks:
            if self.use_checkpoint and self.training and torch.is_grad_enabled():
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        x = F.pad(x, (0, 0, 0, x.shape[2] % 2, 0, x.shape[1] % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


class SwinUNETR(nn.Module):
    def __init__(self, img_size=(352, 352), in_channels: int = 3, out_channels: int = 1,
                 feature_size: int = 24, depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 use_checkpoint: bool = True, spatial_dims: int = 2,
                 generator: Optional[torch.Generator] = None):
        """`img_size` is accepted for the config's sake, as the JAX model
        does: the sizes follow the input."""
        super().__init__()
        if spatial_dims != 2:
            raise ValueError(f"SwinUNETR: only spatial_dims=2 is supported, not {spatial_dims}")
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        fs = feature_size
        self.patch_embed = Conv2d(in_channels, fs, 2, stride=2)
        self.stages = nn.ModuleList(
            [Stage(fs * 2 ** i, d, h, window, g) for i, (d, h) in enumerate(zip(depths, num_heads))])
        self.use_checkpoint = use_checkpoint
        self.enc0 = ResBlock(in_channels, fs)
        self.enc1 = ResBlock(fs, fs)
        self.enc2 = ResBlock(2 * fs, 2 * fs)
        self.enc3 = ResBlock(4 * fs, 4 * fs)
        self.dec4 = ResBlock(16 * fs, 16 * fs)
        self.skip3 = ResBlock(8 * fs, 8 * fs)
        self.up0 = UpBlock(16 * fs, 8 * fs)
        self.up1 = UpBlock(8 * fs, 4 * fs)
        self.up2 = UpBlock(4 * fs, 2 * fs)
        self.up3 = UpBlock(2 * fs, fs)
        self.up4 = UpBlock(fs, fs)
        self.out = Conv2d(fs, out_channels, 1)
        init_flax_style(self, g)

    @property
    def use_checkpoint(self) -> bool:
        return self.stages[0].use_checkpoint

    @use_checkpoint.setter
    def use_checkpoint(self, on: bool) -> None:
        for stage in self.stages:
            stage.use_checkpoint = bool(on)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.patch_embed(x).permute(0, 2, 3, 1)
        hidden = [h]
        for stage in self.stages:
            h = stage(h)
            hidden.append(h)
        chw = [t.permute(0, 3, 1, 2) for t in hidden]
        h = self.up0(self.dec4(chw[4]), self.skip3(chw[3]))
        h = self.up1(h, self.enc3(chw[2]))
        h = self.up2(h, self.enc2(chw[1]))
        h = self.up3(h, self.enc1(chw[0]))
        return self.out(self.up4(h, self.enc0(x)))
