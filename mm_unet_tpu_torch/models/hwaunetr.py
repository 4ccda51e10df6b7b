"""HWAUNETR in PyTorch (counterpart of `mm_unet_tpu/models/hwaunetr.py`): a
four-stage encoder (strided-conv downsampling, GMP conv blocks, MFA blocks,
InstanceNorm + channel MLP), a strided-conv bottleneck to `hidden_size`, and
a transposed-conv decoder whose stages fuse the MFA outputs.

Each MFA block runs a v3 `Mamba` over its map's tokens on the megakernel
route (kernel 1 once per direction; d_state 16) and uses the three
directions' outputs, in the domains the Mamba returns them (the reverse
direction flipped back, the slice direction un-interleaved), as q, k and v
of an attention over the tokens: softmax(qᵀk) with no 1/sqrt(d) scale, its
output v·attᵀ, as the JAX model computes it. The attention is
`F.scaled_dot_product_attention(..., scale=1.0)` with the d_inner channels
as the one head's features: on the card its fused backends keep the
(B, L, L) weights out of memory, which at 512² and batch 8 would be 8.6 GB
per tensor at the first stage (L = 16,384).

InstanceNorms are non-affine at eps 1e-5, GroupNorm(1) closes each decoder
stage, GELUs are exact (the two shallow stages) and the deep stages use
SiLU. `HWABlock` (per-channel multi-scale strided convs, nearest-resized
back with half-pixel centres, `nearest-exact`, and fused) is a module of
the JAX file that HWAUNETR does not call.

Module and parameter names are the torch reference's, as
`mm_unet_tpu.utils.torch_convert.hwaunetr_pairs` tabulates them
(Encoder.downsample_layers, Encoder.gscs, Encoder.stages, Encoder.mlps,
hidden_downsample, TSconv1-4, SegHead).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    GroupNorm,
    LayerNorm,
    init_flax_style,
)
from mm_unet_tpu_torch.models.mamba import Mamba, kernel_launches


def _act(shallow: bool) -> nn.Module:
    return nn.GELU() if shallow else nn.SiLU()


class MlpChannel(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, shallow: bool = True):
        super().__init__()
        self.fc1 = Conv2d(hidden, mlp_dim, 1)
        self.act = _act(shallow)
        self.fc2 = Conv2d(mlp_dim, hidden, 1)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class GMPBlock(nn.Module):
    """Two 3x3 convs beside one 1x1, summed into a 1x1, each conv followed
    by InstanceNorm and the stage's activation; plus the input."""

    def __init__(self, dim: int, shallow: bool = True):
        super().__init__()
        self.proj = Conv2d(dim, dim, 3, padding=1)
        self.proj2 = Conv2d(dim, dim, 3, padding=1)
        self.proj3 = Conv2d(dim, dim, 1)
        self.proj4 = Conv2d(dim, dim, 1)
        self.act = _act(shallow)

    def forward(self, x):
        def cna(conv, v):
            return self.act(F.instance_norm(conv(v), eps=1e-5))

        x1 = cna(self.proj2, cna(self.proj, x))
        return cna(self.proj4, x1 + cna(self.proj3, x)) + x


class MFABlock(nn.Module):
    """LayerNorm over the tokens, a v3 Mamba, the attention of its three
    directions (q, k, v) through a 3x3 conv, and a 3x3 conv over [attention,
    Mamba output]; plus the input."""

    def __init__(self, dim: int, num_slices: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-5)
        self.mamba = Mamba(d_model=dim, bimamba_type="v3", nslices=num_slices,
                           generator=generator)
        self.fussion1 = Conv2d(self.mamba.d_inner, dim, 3, padding=1)
        self.fussion2 = Conv2d(2 * dim, dim, 3, padding=1)

    def forward(self, x):
        b, c, h, w = x.shape
        out, q, k, v = self.mamba(self.norm(x.flatten(2).transpose(1, 2)))
        # (B, d_inner, L) each: one head whose features are the channels,
        # contiguous (SDPA's fused backends need a unit-stride last dim)
        att = F.scaled_dot_product_attention(
            *(t.transpose(1, 2).contiguous()[:, None] for t in (q, k, v)), scale=1.0)
        out_a = self.fussion1(att[:, 0].transpose(1, 2).reshape(b, -1, h, w))
        out_m = out.transpose(1, 2).reshape(b, c, h, w)
        return self.fussion2(torch.cat([out_a, out_m.to(out_a.dtype)], dim=1)) + x


class HWABlock(nn.Module):
    """Each input channel through one strided conv per kernel size (kernel
    = stride), each resized back to the input size by nearest sampling with
    half-pixel centres, the scales fused by a 3x3 conv and weighted by the
    softmax of `weights` over the channels."""

    def __init__(self, in_chans: int = 4, kernel_sizes: Sequence[int] = (1, 2, 4, 8),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weights = nn.Parameter(torch.ones(in_chans))
        self.downs = nn.ModuleList([
            nn.ModuleList([Conv2d(1, 1, ks, stride=ks) for ks in kernel_sizes])
            for _ in range(in_chans)])
        self.fuse = nn.ModuleList([Conv2d(len(kernel_sizes), 1, 3, padding=1)
                                   for _ in range(in_chans)])
        init_flax_style(self, generator if generator is not None
                        else torch.Generator().manual_seed(0))

    def forward(self, x):
        hw = x.shape[2:]
        wn = self.weights.softmax(0)
        outs = []
        for ci, (downs, fuse) in enumerate(zip(self.downs, self.fuse)):
            ch = x[:, ci:ci + 1]
            scales = [F.interpolate(d(ch), size=tuple(hw), mode="nearest-exact") for d in downs]
            outs.append(fuse(torch.cat(scales, dim=1)) * wn[ci])
        return torch.cat(outs, dim=1)


class TransposedConvLayer(nn.Module):
    """r x r stride-r transposed conv, then a 1x1 transposed conv over
    [upsampled, skip] (the skip as wide as the output) and GroupNorm(1)."""

    def __init__(self, dim_in: int, dim_out: int, r: int):
        super().__init__()
        self.transposed1 = ConvTranspose2d(dim_in, dim_out, r, stride=r)
        self.transposed2 = ConvTranspose2d(2 * dim_out, dim_out, 1)
        self.norm = GroupNorm(1, dim_out)

    def forward(self, x, skip):
        return self.norm(self.transposed2(torch.cat([self.transposed1(x), skip], dim=1)))


class Encoder(nn.Module):
    def __init__(self, in_chans, kernel_sizes, depths, dims, num_slices_list, generator):
        super().__init__()
        self.downsample_layers = nn.ModuleList()
        cin = in_chans
        for i, (ks, dim) in enumerate(zip(kernel_sizes, dims)):
            conv = Conv2d(cin, dim, ks, stride=ks)
            self.downsample_layers.append(
                nn.Sequential(conv) if i == 0
                else nn.Sequential(nn.InstanceNorm2d(cin, eps=1e-5), conv))
            cin = dim
        self.gscs = nn.ModuleList([GMPBlock(d, shallow=i <= 1) for i, d in enumerate(dims)])
        self.stages = nn.ModuleList([
            nn.Sequential(*(MFABlock(d, ns, generator) for _ in range(n)))
            for d, ns, n in zip(dims, num_slices_list, depths)])
        self.mlps = nn.ModuleList([MlpChannel(d, 2 * d, shallow=i < 2)
                                   for i, d in enumerate(dims)])

    def forward(self, x):
        """(the MFA outputs of the four stages, the last stage's MLP output):
        the MLP continues from the GMP block's output, not the MFA blocks'."""
        feats = []
        for down, gsc, stage, mlp in zip(self.downsample_layers, self.gscs, self.stages,
                                         self.mlps):
            x = gsc(down(x))
            feats.append(stage(x))
            x = mlp(F.instance_norm(x, eps=1e-5))
        return feats, x


class HWAUNETR(nn.Module):
    def __init__(self, in_chans: int = 4, out_chans: int = 3,
                 kernel_sizes: Sequence[int] = (4, 2, 2, 2), depths: Sequence[int] = (1, 1, 1, 1),
                 dims: Sequence[int] = (48, 96, 192, 384),
                 num_slices_list: Sequence[int] = (64, 32, 16, 8), hidden_size: int = 768,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.Encoder = Encoder(in_chans, kernel_sizes, depths, dims, num_slices_list, g)
        self.hidden_downsample = Conv2d(dims[3], hidden_size, 2, stride=2)
        ups = ((hidden_size, dims[3], 2), (dims[3], dims[2], kernel_sizes[3]),
               (dims[2], dims[1], kernel_sizes[2]), (dims[1], dims[0], kernel_sizes[1]))
        for i, (cin, cout, r) in enumerate(ups):
            self.add_module(f"TSconv{i + 1}", TransposedConvLayer(cin, cout, r))
        self.SegHead = ConvTranspose2d(dims[0], out_chans, kernel_sizes[0],
                                       stride=kernel_sizes[0])
        init_flax_style(self, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats, h = self.Encoder(x)
        out = self.hidden_downsample(h)
        for i, skip in enumerate(reversed(feats)):
            out = getattr(self, f"TSconv{i + 1}")(out, skip)
        return self.SegHead(out)

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """Launches of each kernel one forward makes, counted from the
        Mambas: three fused scans per MFA block."""
        return kernel_launches(self)

    def kernel_launches_per_train_step(self) -> dict:
        """Forward and backward launches of each kernel in one train step:
        every scan of the forward has one backward."""
        return {k: {"fwd": v, "bwd": v} for k, v in self.kernel_launches_per_forward().items()}
