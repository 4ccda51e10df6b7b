"""FCBFormer in PyTorch (counterpart of `mm_unet_tpu/models/fcbformer.py`):
a transformer branch (PVTv2-b3's four maps, each through two residual
blocks and nearest-upsampled to 1/4, then fused top-down), a fully
convolutional UNet branch at full size, and a head of two residual blocks
and a 1x1 conv over both branches, the first upsampled (nearest) to the
input size.

Nearest upsampling takes the source pixel at floor((i + 0.5) * in / out),
as `jax.image.resize(..., "nearest")` does (`nearest-exact`). The residual
blocks use GroupNorm(32) and SiLU. `.eval()` and `.train()` compute the
same function (the PVT's drop path is 0). Module and parameter names are
the torch reference's (`src/FCBFormer/models.py`: TB.backbone.0.proj,
TB.backbone.1.0.attn.q, TB.LE.0.0.in_layers.0, TB.SFA.2.1, FCB.enc_blocks.0,
FCB.enc_blocks.1.0.skip, FCB.middle_block.0, FCB.dec_blocks.2.1.1, PH.2),
as `mm_unet_tpu.utils.torch_convert.fcbformer_pairs` tabulates them, so
`utils.convert` maps JAX variables onto this model.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import Conv2d, GroupNorm, init_flax_style
from mm_unet_tpu_torch.models.pvtv2 import pvt_v2_b3, pyramid


def _up_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


class UpNearest2x(nn.Module):
    def forward(self, x):
        return _up_nearest(x, (x.shape[2] * 2, x.shape[3] * 2))


class RB(nn.Module):
    """(GroupNorm(32), SiLU, 3x3 conv) twice, plus the input (a 1x1 conv of
    it when the width changes)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm(32, in_channels), nn.SiLU(),
                                       Conv2d(in_channels, out_channels, 3, padding=1))
        self.out_layers = nn.Sequential(GroupNorm(32, out_channels), nn.SiLU(),
                                        Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip = (Conv2d(in_channels, out_channels, 1) if in_channels != out_channels
                     else nn.Identity())

    def forward(self, x):
        return self.out_layers(self.in_layers(x)) + self.skip(x)


class FCB(nn.Module):
    """The fully convolutional branch: a 3x3 conv, six levels of two RBs
    (stride-2 convs between them), two middle RBs, and six decoder levels
    of three RBs over [x, skip], each level but the last ending in a x2
    nearest upsampling and a 3x3 conv."""

    def __init__(self, in_channels: int = 3, min_level_channels: int = 32,
                 min_channel_mults=(1, 1, 2, 2, 4, 4), n_levels: int = 6, n_rbs: int = 2):
        super().__init__()
        mc = min_level_channels
        self.enc_blocks = nn.ModuleList([Conv2d(in_channels, mc, 3, padding=1)])
        chans, ch = [mc], mc
        for level in range(n_levels):
            for _ in range(n_rbs):
                self.enc_blocks.append(nn.Sequential(RB(ch, min_channel_mults[level] * mc)))
                ch = min_channel_mults[level] * mc
                chans.append(ch)
            if level != n_levels - 1:
                self.enc_blocks.append(nn.Sequential(Conv2d(ch, ch, 3, stride=2, padding=1)))
                chans.append(ch)
        self.middle_block = nn.Sequential(RB(ch, ch), RB(ch, ch))
        self.dec_blocks = nn.ModuleList()
        for level in range(n_levels):
            out = min_channel_mults[::-1][level] * mc
            for block in range(n_rbs + 1):
                layers = [RB(ch + chans.pop(), out)]
                ch = out
                if level < n_levels - 1 and block == n_rbs:
                    layers.append(nn.Sequential(UpNearest2x(), Conv2d(ch, ch, 3, padding=1)))
                self.dec_blocks.append(nn.Sequential(*layers))

    def forward(self, x):
        hs = []
        for blk in self.enc_blocks:
            x = blk(x)
            hs.append(x)
        x = self.middle_block(x)
        for blk in self.dec_blocks:
            x = blk(torch.cat([x, hs.pop()], dim=1))
        return x


class TB(nn.Module):
    """The transformer branch: PVTv2-b3 flattened into a Sequential (the
    reference's `backbone`), LE (two RBs to 64 channels per level, then
    nearest to 1/4) and SFA (two RBs over [level, fused], from the top)."""

    def __init__(self, generator: torch.Generator):
        super().__init__()
        self.backbone = nn.Sequential(*pvt_v2_b3(generator).children())
        self.LE = nn.ModuleList([nn.Sequential(RB(dim, 64), RB(64, 64))
                                 for dim in (64, 128, 320, 512)])
        self.SFA = nn.ModuleList([nn.Sequential(RB(128, 64), RB(64, 64)) for _ in range(3)])

    def forward(self, x):
        quarter = (x.shape[2] // 4, x.shape[3] // 4)
        emph = [_up_nearest(le(level), quarter)
                for le, level in zip(self.LE, pyramid(list(self.backbone), x))]
        fused = emph[-1]
        for i in (2, 1, 0):
            fused = self.SFA[i](torch.cat([emph[i], fused], dim=1))
        return fused


class FCBFormer(nn.Module):
    def __init__(self, size: int = 352, num_class: int = 1, model_dir: str = "",
                 generator: Optional[torch.Generator] = None):
        """`size` is accepted for the config's sake and unused, as in the JAX
        model. `model_dir` names the reference's `pvt_v2_b3.pth` (not in the
        repo): the constructor does not read it; `create_train_state`
        warm-starts the backbone from it (`utils/torch_convert.py::warm_start`),
        as the JAX package's does."""
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.TB = TB(g)
        self.FCB = FCB()
        self.PH = nn.Sequential(RB(96, 64), RB(64, 64), Conv2d(64, num_class, 1))
        init_flax_style(self, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = _up_nearest(self.TB(x), x.shape[2:])
        return self.PH(torch.cat([x1, self.FCB(x)], dim=1))
