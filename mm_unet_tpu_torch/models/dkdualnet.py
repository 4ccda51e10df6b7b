"""dkDualNet in PyTorch (counterpart of `mm_unet_tpu/models/dkdualnet.py`):
a DLK large-kernel encoder, three AttentionBlocks whose two MambaAttentions
each run a v2 bi-Mamba over their feature map's tokens, ConvBlock fuse
heads and transpose-conv outputs.

`.eval()` is the JAX model's `train=False`; `.train()` normalises with the
batch statistics and draws the DropPath masks (from the generator that
`set_dropout_generator` sets). Activations are NCHW; the LayerNorms reduce
over channels in f32.

Module and parameter names are the torch reference's, as tabulated by
`mm_unet_tpu.utils.torch_convert.dkdualnet_pairs`, with one exception: the
reference's DLKBlock shares one LayerNorm and one `layer_scale` between its
two branches, while the JAX module has separate ones. The port computes
what the JAX package computes, so it keeps two of each; the second ones are
`norm_layer2` and `layer_scale2` (a converter maps the table's second
entries there).

`scan_impl` chooses the Mambas' route (`models/mamba.py`): None takes the
megakernel (`mamba_fused_scan`, two launches per Mamba), "pallas" the
grouped selective scan (`selective_scan`, one launch per Mamba). Both
compute the same function from the same weights.
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
    DropPath,
    LayerNorm,
    init_flax_style,
    nchw_to_nhwc,
    nhwc_to_nchw,
    resize_linear,
)
from mm_unet_tpu_torch.models.mamba import Mamba, kernel_launches


def _norm2d(norm: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A channel LayerNorm on an NCHW map."""
    return nhwc_to_nchw(norm(nchw_to_nhwc(x)))


def _act(shallow: bool) -> nn.Module:
    return nn.GELU() if shallow else nn.SiLU()  # Swish == SiLU


def _spatial_se() -> nn.Sequential:
    return nn.Sequential(Conv2d(2, 2, 7, padding=3), nn.Sigmoid())


def _gate(att1: torch.Tensor, att2: torch.Tensor, spatial_se: nn.Module) -> torch.Tensor:
    """att1 * se0 + att2 * se1, se = sigmoid(conv([mean; max] over channels))."""
    att = torch.cat([att1, att2], dim=1)
    pooled = torch.cat([att.mean(1, keepdim=True), att.amax(1, keepdim=True)], dim=1)
    se = spatial_se(pooled)
    return att1 * se[:, :1] + att2 * se[:, 1:]


class Mlp(nn.Module):
    def __init__(self, dim: int, shallow: bool = False):
        super().__init__()
        self.fc1 = Conv2d(dim, 4 * dim, 1)
        self.dwconv = Conv2d(4 * dim, 4 * dim, 3, padding=1, groups=4 * dim)
        self.act = _act(shallow)
        self.fc2 = Conv2d(4 * dim, dim, 1)

    def forward(self, x):
        return self.fc2(self.act(self.dwconv(self.fc1(x))))


class DLK(nn.Module):
    """The spatial gating unit: a 5x5 depthwise conv, a dilated 7x7 one on
    its output, gated against each other, plus the input."""

    def __init__(self, dim: int):
        super().__init__()
        self.att_conv1 = Conv2d(dim, dim, 5, padding=2, groups=dim)
        self.att_conv2 = Conv2d(dim, dim, 7, padding=9, dilation=3, groups=dim)
        self.spatial_se = _spatial_se()

    def forward(self, x):
        att1 = self.att_conv1(x)
        att2 = self.att_conv2(att1)
        return _gate(att1, att2, self.spatial_se) + x


class DLKAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj_1 = Conv2d(dim, dim, 1)
        self.spatial_gating_unit = DLK(dim)
        self.proj_2 = Conv2d(dim, dim, 1)

    def forward(self, x):
        return self.proj_2(self.spatial_gating_unit(F.gelu(self.proj_1(x))))  # exact erf


class DLKBlock(nn.Module):
    def __init__(self, dim: int, shallow: bool = False, drop_path: float = 0.0):
        super().__init__()
        self.norm_layer = LayerNorm(dim, eps=1e-6)
        self.norm_layer2 = LayerNorm(dim, eps=1e-6)
        self.layer_scale = nn.Parameter(torch.full((dim,), 1e-6))
        self.layer_scale2 = nn.Parameter(torch.full((dim,), 1e-6))
        self.attn = DLKAttention(dim)
        self.mlp = Mlp(dim, shallow)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        h = self.attn(_norm2d(self.norm_layer, x))
        x = x + self.drop_path(self.layer_scale[:, None, None] * h)
        m = self.mlp(_norm2d(self.norm_layer2, x))
        return x + self.drop_path(self.layer_scale2[:, None, None] * m)


class ConvBlock(nn.Module):
    """Two (3x3 conv, BatchNorm, activation) layers."""

    def __init__(self, in_dim: int, dim: int, shallow: bool = False):
        super().__init__()
        self.conv1 = nn.Sequential(Conv2d(in_dim, dim, 3, padding=1), BatchNorm2d(dim),
                                   _act(shallow))
        self.conv2 = nn.Sequential(Conv2d(dim, dim, 3, padding=1), BatchNorm2d(dim),
                                   _act(shallow))

    def forward(self, x):
        return self.conv2(self.conv1(x))


class MambaAttention(nn.Module):
    """Large- (dilated 7x7) or small- (5x5) kernel depthwise conv, a v2
    bi-Mamba over the map's tokens, the spatial gate of input and Mamba
    output, and a 3x3 conv to `out_dim`."""

    def __init__(self, in_dim: int, out_dim: int, num_slices: int = 4, goble: bool = True,
                 scan_impl: Optional[str] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if goble:
            self.att_conv = Conv2d(in_dim, in_dim, 7, padding=9, dilation=3, groups=in_dim)
        else:
            self.att_conv = Conv2d(in_dim, in_dim, 5, padding=2, groups=in_dim)
        self.norm = LayerNorm(in_dim, eps=1e-5)
        self.mamba = Mamba(d_model=in_dim, bimamba_type="v2", nslices=num_slices,
                           scan_impl=scan_impl, generator=generator)
        self.spatial_se = _spatial_se()
        self.conv = Conv2d(in_dim, out_dim, 3, padding=1)

    def forward(self, x):
        h = self.att_conv(x)
        b, c, hh, ww = h.shape
        tokens = self.norm(nchw_to_nhwc(h).reshape(b, hh * ww, c))
        att2 = nhwc_to_nchw(self.mamba(tokens).reshape(b, hh, ww, c))
        return self.conv(_gate(x, att2, self.spatial_se))


class AttentionBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_slices: int = 4, shallow: bool = True,
                 scan_impl: Optional[str] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        half = self.half = in_dim // 2
        self.gobel_attention = MambaAttention(half, out_dim, num_slices, True, scan_impl,
                                              generator)
        self.local_attention = MambaAttention(half, out_dim, num_slices, False, scan_impl,
                                              generator)
        self.downsample = ConvBlock(2 * out_dim, out_dim, shallow)

    def forward(self, x):
        x0 = self.gobel_attention(x[:, :self.half])
        x1 = self.local_attention(x[:, self.half:])
        return self.downsample(torch.cat([x0, x1], dim=1))


class DLKEncoder(nn.Module):
    """Four stages of (downsampling conv, channel LayerNorm, DLKBlocks)."""

    def __init__(self, in_channels: int, dims: Sequence[int], depths: Sequence[int],
                 drop_path_rate: float):
        super().__init__()
        total = sum(depths)
        rates = [drop_path_rate * i / (total - 1) if total > 1 else 0.0 for i in range(total)]
        self.downsample_layers = nn.ModuleList(
            [Conv2d(in_channels, dims[0], 7, stride=2, padding=3)]
            + [Conv2d(dims[i - 1], dims[i], 2, stride=2) for i in range(1, 4)])
        self.norm_layers = nn.ModuleList([LayerNorm(d, eps=1e-6) for d in dims])
        cur, stages = 0, []
        for i in range(4):
            stages.append(nn.ModuleList([DLKBlock(dims[i], shallow=i < 2, drop_path=rates[cur + j])
                                         for j in range(depths[i])]))
            cur += depths[i]
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        feats = []
        for down, norm, blocks in zip(self.downsample_layers, self.norm_layers, self.stages):
            x = _norm2d(norm, down(x))
            for blk in blocks:
                x = blk(x)
            feats.append(x)
        return feats


class dkDualNet(nn.Module):
    """(B, in_channels, H, W) -> (B, out_channels, H, W) logits; H and W
    divisible by 16 (four halvings)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 depths: Sequence[int] = (2, 2, 2, 2), dims: Sequence[int] = (48, 96, 192, 384),
                 kernel_size: int = 3, out_dim: int = 64,
                 num_slices_list: Sequence[int] = (64, 32, 16, 8), drop_path_rate: float = 0.3,
                 scan_impl: Optional[str] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        del kernel_size  # the JAX constructor takes it and uses it nowhere
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        od, ns = out_dim, num_slices_list
        self.dnet_down = DLKEncoder(in_channels, dims, depths, drop_path_rate)
        self.block4 = AttentionBlock(dims[3], od, ns[3], False, scan_impl, g)
        self.block3 = AttentionBlock(dims[2], od, ns[2], False, scan_impl, g)
        self.block2 = AttentionBlock(dims[1], od, ns[1], True, scan_impl, g)
        self.fuse2 = nn.Sequential(ConvBlock(2 * od, od, shallow=False),
                                   Conv2d(od, out_channels, 1, bias=False))
        self.L_feature = ConvBlock(dims[0], od, shallow=True)
        self.fuse = ConvBlock(od, od, shallow=True)
        self.o1_u = ConvTranspose2d(out_channels, out_channels, 4, stride=4)
        self.o2_u = ConvTranspose2d(2 * od, out_channels, 2, stride=2)
        self.head = Conv2d(2 * out_channels, out_channels, 1, bias=False)
        init_flax_style(self, g)

    @property
    def scan_impl(self) -> Optional[str]:
        """The Mambas' route; setting it sets every Mamba's."""
        return next(m.scan_impl for m in self.modules() if isinstance(m, Mamba))

    @scan_impl.setter
    def scan_impl(self, impl: Optional[str]) -> None:
        for m in self.modules():
            if isinstance(m, Mamba):
                m.scan_impl = impl

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw every DropPath mask from `generator` (on the model's device)."""
        for m in self.modules():
            if isinstance(m, DropPath):
                m.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1, c2, c3, c4 = self.dnet_down(x)
        _c4 = resize_linear(self.block4(c4), c3.shape[2:])
        _c3 = self.block3(c3)
        _c2 = self.block2(c2)
        fused = torch.cat([resize_linear(_c4, c2.shape[2:]), resize_linear(_c3, c2.shape[2:])],
                          dim=1)
        out1 = self.fuse2(fused)
        lf = self.L_feature(c1)
        hf = resize_linear(self.fuse(_c2), lf.shape[2:])
        out1 = self.o1_u(out1)
        out2 = self.o2_u(torch.cat([hf, lf], dim=1))
        return self.head(torch.cat([out1, out2], dim=1))

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """Launches of each kernel one forward makes, counted from the
        Mambas (six of them, two per AttentionBlock)."""
        return kernel_launches(self)

    def kernel_launches_per_train_step(self) -> dict:
        """Forward and backward launches of each kernel in one train step:
        every scan of the forward has one backward."""
        return {k: {"fwd": v, "bwd": v} for k, v in self.kernel_launches_per_forward().items()}
