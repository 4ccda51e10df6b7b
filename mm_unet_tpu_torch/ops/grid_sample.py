"""Bilinear grid sampling with PyTorch `grid_sample` semantics (counterpart
of `mm_unet_tpu/ops/grid_sample.py::grid_sample_bilinear`): mode
'bilinear', padding 'zeros', align_corners=True, the configuration of the
reference's deformable sampling. The JAX package builds it from XLA
gathers; here it is `F.grid_sample` itself. Grid value -1 maps to pixel 0
and +1 to pixel size - 1; corners outside the map read zero."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_bilinear(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """feat (B, C, H, W); grid (B, Hg, Wg, 2), grid[..., 0] = x and
    grid[..., 1] = y in [-1, 1]. Returns (B, C, Hg, Wg) in feat's dtype,
    sampled in f32 (the JAX function takes its coordinates in f32)."""
    out = F.grid_sample(feat.float(), grid.float(), mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.to(feat.dtype)
