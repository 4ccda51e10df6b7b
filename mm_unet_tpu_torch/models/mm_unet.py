"""MM_Net, the Morph-Mamba U-Net, in PyTorch (counterpart of
`mm_unet_tpu/models/mm_unet.py`). `.eval()` is the JAX model's
`train=False`: BatchNorm uses its running statistics and the side outputs'
Dropout2d is off. `.train()` is `train=True`: BatchNorm normalises with the
batch statistics and updates the running ones, Dropout2d draws its masks,
and with `remat=True` each MMConv recomputes its sample-and-conv part in
the backward pass.

Module and parameter names are the torch reference's, as tabulated by
`mm_unet_tpu.utils.torch_convert.mm_net_pairs`, so `utils.convert` maps JAX
variables onto this model. Activations are NCHW; each MMConv crosses to NHWC
for the tap-conv kernel.

`mamba_dtype` sets the compute dtype of the whole feature path (convs, norm
outputs, Mamba streams); parameters and norm statistics keep their dtype,
norms reduce in f32, and the coordinate geometry, the scan state and the
output logits stay f32 (the reference's `_lkw` rule).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mm_unet_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    Dropout2d,
    GroupNorm,
    grid_sample_conv,
    init_flax_style,
    nchw_to_nhwc,
    nhwc_to_nchw,
    resize_bilinear_align_corners,
    row_sample_conv,
)
from mm_unet_tpu_torch.models.mamba import Mamba, kernel_launches
from mm_unet_tpu_torch.ops.geometry import (
    accumulate_offsets_from_center_last,
    inverse_two_row_flatten_tokens,
    two_row_flatten_tokens,
)


class MMConv(nn.Module):
    """Morph-Mamba deformable conv: offset conv 3x3 -> GroupNorm(k) -> tanh
    -> row coordinates (cumulative offsets from the kernel centre, refined
    by a TFM Mamba over the serpentine-flattened offset field) -> sample and
    conv -> GroupNorm(out/4). Morph 0 (every MMConv of MM_Net) fuses the row
    sample and the (k,1) stride-k conv in `tap_conv`. Morph 1 grid-samples
    a (B, H*K, W) map, tap j of row h at row y and column clamp(w + j -
    k//2), and applies the (1,k) stride-(1,k) conv `dsc_conv_y`: its output
    is (B, F, H*K, W//k), the JAX module's shape (`mm_unet.py:128-140`).

    `remat` (set through MM_Net.remat) wraps the sample-and-conv part, tap-conv plus
    GroupNorm, in `torch.utils.checkpoint` while training with grad enabled:
    its activations are recomputed in the backward pass instead of kept (the
    JAX model's `nn.remat` boundary, `mm_unet.py:123-149`)."""

    remat = False

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 9,
                 extend_scope: float = 1.0, num_slices: int = 4,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, morph: int = 0):
        super().__init__()
        if morph not in (0, 1):
            raise ValueError("morph should be 0 or 1.")
        k = self.kernel_size = kernel_size
        self.extend_scope, self.morph = extend_scope, morph
        self.offset_conv = Conv2d(in_channels, 2 * k, 3, padding=1, compute_dtype=dtype)
        self.gn_offset = GroupNorm(k, 2 * k, compute_dtype=dtype)
        self.mamba = Mamba(d_model=k, d_state=16, d_conv=4, expand=2, nslices=num_slices,
                           dtype=dtype, generator=generator)
        self.altho = nn.Parameter(torch.tensor(math.log(math.e - 1.0)))
        if morph == 0:
            # holds the (k,1) stride-k conv's weights; applied by tap_conv
            self.dsc_conv_x = Conv2d(in_channels, out_channels, (k, 1), stride=(k, 1))
        else:
            self.dsc_conv_y = Conv2d(in_channels, out_channels, (1, k), stride=(1, k),
                                     compute_dtype=dtype)
        self.gn = GroupNorm(out_channels // 4, out_channels, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        k = self.kernel_size
        offset = torch.tanh(self.gn_offset(self.offset_conv(x)))
        y_off = nchw_to_nhwc(offset[:, :k])  # (B, H, W, K); x offsets unused
        # coordinates in f32: bf16 would snap row indices up to H to whole rows
        acc = accumulate_offsets_from_center_last(y_off.float())
        rows = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None, None]
        y_new = rows + acc * self.extend_scope
        m_out = self.mamba(two_row_flatten_tokens(y_off))[0].float()
        y_keep = inverse_two_row_flatten_tokens(m_out, h, w)
        weight = torch.clamp(F.softplus(self.altho.float()), min=0.01)
        y = weight * y_keep + y_new
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(self._sample_conv, nchw_to_nhwc(x), y, use_reentrant=False)
        return self._sample_conv(nchw_to_nhwc(x), y)

    def _sample_conv(self, feat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        if self.morph == 1:
            b, h, w, _ = feat.shape
            cols = torch.arange(w, dtype=torch.float32, device=feat.device)[:, None]
            spread = torch.linspace(-(k // 2), k // 2, k, device=feat.device)
            # (B, H, W, K) -> (B, H*K, W): the taps of a row become rows
            y_map = y.permute(0, 1, 3, 2).reshape(b, h * k, w)
            x_map = (cols + spread).T.expand(b, h, k, w).reshape(b, h * k, w)
            return grid_sample_conv(feat, y_map, x_map, self.dsc_conv_y, self.gn)
        return row_sample_conv(feat, y, self.dsc_conv_x, self.gn)


class CBAM(nn.Module):
    """Channel + spatial attention; means reduce in f32."""

    def __init__(self, channel: int, reduction: int = 16, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = nn.Sequential(
            Conv2d(channel, channel // reduction, 1, bias=False, compute_dtype=dtype),
            nn.ReLU(),
            Conv2d(channel // reduction, channel, 1, bias=False, compute_dtype=dtype),
        )
        # the 7x7 spatial-attention conv runs in its input's dtype
        self.conv = Conv2d(2, 1, 7, padding=3, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c_avg = self.mlp(x.float().mean((2, 3), keepdim=True).to(x.dtype))
        c_max = self.mlp(x.amax((2, 3), keepdim=True))
        y1 = torch.sigmoid(c_avg + c_max) * x
        s_avg = y1.float().mean(1, keepdim=True).to(y1.dtype)
        s_max = y1.amax(1, keepdim=True)
        s_in = torch.cat([s_max, s_avg], dim=1)
        s = F.conv2d(s_in, self.conv.weight.to(s_in.dtype), padding=3)
        return torch.sigmoid(s) * y1


def _mmconv_bn_relu(cin, cout, k, ns, dtype, g):
    return nn.Sequential(MMConv(cin, cout, k, num_slices=ns, dtype=dtype, generator=g),
                         BatchNorm2d(cout, dtype), nn.ReLU())


class SideoutBlock(nn.Module):
    """MMConv -> BN -> ReLU -> Dropout2d(drop) -> 1x1 conv."""

    def __init__(self, in_channels, out_channels, num_slices=4, dtype=None, generator=None,
                 drop: float = 0.1):
        super().__init__()
        mid = in_channels // 4
        self.conv1 = _mmconv_bn_relu(in_channels, mid, 3, num_slices, dtype, generator)
        self.drop = Dropout2d(drop)
        self.conv2 = Conv2d(mid, out_channels, 1, compute_dtype=dtype)

    def forward(self, x):
        return self.conv2(self.drop(self.conv1(x)))


class RCG(nn.Module):
    """Reverse-context gating with a Mamba detour at twice the resolution."""

    def __init__(self, d_state=16, d_conv=4, expand=2, num_slices=4, dtype=None,
                 generator=None):
        super().__init__()
        self.conv1 = _mmconv_bn_relu(128, 64, 3, num_slices, dtype, generator)
        self.upsample = ConvTranspose2d(64, 64, 4, stride=2, padding=1, compute_dtype=dtype)
        self.mamba = Mamba(d_model=64, d_state=d_state, d_conv=d_conv, expand=expand,
                           nslices=num_slices, dtype=dtype, generator=generator)
        self.downsample = Conv2d(64, 64, 4, stride=2, padding=1, compute_dtype=dtype)
        self.mlp = nn.Sequential(Conv2d(64, 1, 1, compute_dtype=dtype), nn.Sigmoid())

    def forward(self, pre, edge, f):
        r = (1.0 - torch.sigmoid(pre)) * f
        edge1 = resize_bilinear_align_corners(edge, f.shape[2:])
        x2 = self.conv1(torch.cat([edge1.to(r.dtype), r], dim=1))
        x0 = self.upsample(x2)
        b, c, h2, w2 = x0.shape
        tokens = nchw_to_nhwc(x0).reshape(b, h2 * w2, c)
        out = self.mamba(tokens)[0]
        out_m = nhwc_to_nchw(out.to(x2.dtype).reshape(b, h2, w2, c))
        return self.downsample(out_m) * self.mlp(x2) * x2 + f


class DecoderBlock(nn.Module):
    """Two MMConvs + 2x bilinear upsample."""

    def __init__(self, in_channels, out_channels, num_slices=4, dtype=None, generator=None):
        super().__init__()
        self.conv1 = _mmconv_bn_relu(in_channels, in_channels // 4, 3, num_slices, dtype,
                                     generator)
        self.conv2 = _mmconv_bn_relu(in_channels // 4, out_channels, 3, num_slices, dtype,
                                     generator)

    def forward(self, x):
        x = self.conv2(self.conv1(x))
        return resize_bilinear_align_corners(x, (x.shape[2] * 2, x.shape[3] * 2))


class ResidualBlock(nn.Module):
    """MMConv residual block; the downsampling form has a strided 3x3 conv
    before its MMConv and a strided 1x1 shortcut."""

    def __init__(self, in_channels, out_channels, num_slices, downsample=False, dtype=None,
                 generator=None):
        super().__init__()
        self.downsample = downsample
        g = generator

        def mm(cin):
            return MMConv(cin, out_channels, 3, num_slices=num_slices, dtype=dtype, generator=g)

        if downsample:
            self.block1 = nn.Sequential(
                Conv2d(in_channels, out_channels, 3, stride=2, padding=1, bias=False,
                       compute_dtype=dtype),
                BatchNorm2d(out_channels, dtype), nn.ReLU(),
                mm(out_channels), BatchNorm2d(out_channels, dtype),
            )
            self.block2 = nn.Sequential(
                Conv2d(in_channels, out_channels, 1, stride=2, bias=False, compute_dtype=dtype),
                BatchNorm2d(out_channels, dtype),
            )
        else:
            self.block1 = nn.Sequential(
                mm(in_channels), BatchNorm2d(out_channels, dtype), nn.ReLU(),
                mm(out_channels), BatchNorm2d(out_channels, dtype),
            )

    def forward(self, x):
        if self.downsample:
            return F.relu(self.block2(x) + self.block1(x))
        return F.relu(self.block1(x) + x)


def validate_input_size(h: int, w: int, num_slices_list=(64, 32, 16, 8)):
    """MM_Net's v3 slice-scan divisibility constraints for an input size:
    stage i scans (h/2^(i+2))*(w/2^(i+2)) tokens in num_slices_list[i]
    slices. Raises ValueError naming the failing stage; returns the per-stage
    token counts."""
    if h % 32 or w % 32:
        raise ValueError(f"MM_Net input must be divisible by 32, got {h}x{w}")
    tokens = []
    for i, ns in enumerate(num_slices_list):
        t = (h // (4 << i)) * (w // (4 << i))
        tokens.append(t)
        if t % ns:
            raise ValueError(
                f"MM_Net stage {i + 2}: {t} tokens not divisible by "
                f"num_slices_list[{i}]={ns} (input {h}x{w}). Choose a slice "
                f"list whose entries divide the per-stage token counts "
                f"{tokens} — e.g. 704² works with (64, 32, 16, 4)."
            )
    return tokens


class MM_Net(nn.Module):
    """(B, 3, H, W) -> (B, num_classes, H, W) f32 logits: the sum of four
    side outputs and the contour logits, each bilinearly upsampled
    (align_corners=True) to the input size.

    `remat` and `sideout_drop` take the JAX model's defaults
    (`mm_unet.py:488,495`): MMConv recompute in the backward pass, and the
    side outputs' Dropout2d rate."""

    def __init__(self, num_classes: int = 1,
                 num_slices_list: Sequence[int] = (64, 32, 16, 8),
                 depths: Sequence[int] = (3, 4, 6, 3),
                 mamba_dtype: Optional[str] = "bfloat16",
                 generator: Optional[torch.Generator] = None,
                 remat: bool = True,
                 sideout_drop: float = 0.1):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        dt = getattr(torch, mamba_dtype) if mamba_dtype else None
        ns = list(num_slices_list)
        self.num_slices_list = tuple(ns)
        d1, d2, d3, d4 = depths

        def stage(cin, cout, n_slices, depth, downsample):
            blocks = [ResidualBlock(cin, cout, n_slices, downsample, dt, g)]
            blocks += [ResidualBlock(cout, cout, n_slices, False, dt, g) for _ in range(depth - 1)]
            return nn.Sequential(*blocks)

        self.encoder1 = nn.Sequential(
            Conv2d(3, 64, 7, stride=2, padding=3, bias=False, compute_dtype=dt),
            BatchNorm2d(64, dt), nn.ReLU(),
        )
        self.encoder2 = stage(64, 64, ns[0], d1, False)
        self.encoder3 = stage(64, 128, ns[1], d2, True)
        self.encoder4 = stage(128, 256, ns[2], d3, True)
        self.encoder5 = stage(256, 512, ns[3], d4, True)
        # 1x1 MMConv channel reducers
        self.down3 = _mmconv_bn_relu(128, 64, 1, ns[-1], dt, g)
        self.down4 = _mmconv_bn_relu(256, 64, 1, ns[-1], dt, g)
        self.down5 = _mmconv_bn_relu(512, 64, 1, ns[-1], dt, g)
        self.decoder5 = DecoderBlock(64, 64, ns[3], dt, g)
        self.side5 = SideoutBlock(64, num_classes, ns[3], dt, g, sideout_drop)
        # contour branch
        self.cbam = nn.Sequential(
            Conv2d(64, 64, 3, padding=1, compute_dtype=dt), BatchNorm2d(64, dt), nn.ReLU(),
            CBAM(64, dtype=dt),
            Conv2d(64, 64, 3, padding=1, compute_dtype=dt), BatchNorm2d(64, dt), nn.ReLU(),
        )
        self.line_predict = Conv2d(64, 1, 3, padding=1, compute_dtype=dt)
        for n, s in ((4, ns[2]), (3, ns[1]), (2, ns[0])):
            self.add_module(f"rcg{n}", RCG(num_slices=s, dtype=dt, generator=g))
            self.add_module(f"decoder{n}", DecoderBlock(128, 64, s, dt, g))
            self.add_module(f"side{n}", SideoutBlock(64, num_classes, s, dt, g, sideout_drop))
        init_flax_style(self, g)
        self.remat = remat

    @property
    def remat(self) -> bool:
        """Whether the MMConvs recompute their sample-and-conv part in the
        backward pass; setting it sets every MMConv's flag."""
        return any(m.remat for m in self.modules() if isinstance(m, MMConv))

    @remat.setter
    def remat(self, on: bool) -> None:
        for m in self.modules():
            if isinstance(m, MMConv):
                m.remat = bool(on)

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw every Dropout2d mask from `generator` (on the model's device)."""
        for m in self.modules():
            if isinstance(m, Dropout2d):
                m.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_hw = x.shape[2:]
        e1 = self.encoder1(x)
        e2 = self.encoder2(F.max_pool2d(e1, 3, 2, 1))
        e3 = self.encoder3(e2)
        e4 = self.encoder4(e3)
        e5 = self.encoder5(e4)
        e3d, e4d, e5d = self.down3(e3), self.down4(e4), self.down5(e5)

        d5 = self.decoder5(e5d)
        out5 = self.side5(d5)
        c1 = self.cbam(e1)
        p_c = self.line_predict(c1)

        r4 = self.rcg4(out5, c1, e4d)
        d4 = self.decoder4(torch.cat([d5, r4], dim=1))
        out4 = self.side4(d4)
        r3 = self.rcg3(out4, c1, e3d)
        d3 = self.decoder3(torch.cat([d4, r3], dim=1))
        out3 = self.side3(d3)
        r2 = self.rcg2(out3, c1, e2)
        d2 = self.decoder2(torch.cat([d3, r2], dim=1))
        out2 = self.side2(d2)

        return sum(resize_bilinear_align_corners(o.float(), in_hw)
                   for o in (out2, out3, out4, out5, p_c))

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """Launches of each kernel one forward makes, counted from the
        modules: three fused scans per (v3) Mamba, one tap-conv per MMConv."""
        mmconvs = sum(isinstance(m, MMConv) and m.morph == 0 for m in self.modules())
        return {**kernel_launches(self), "tap_conv": mmconvs}

    def kernel_launches_per_train_step(self) -> dict:
        """Forward and backward launches of each kernel in one train step
        (forward in train mode, then backward), counted from the modules:
        every scan and tap-conv of the forward has a backward; with `remat`
        the tap-conv forward runs a second time per MMConv, in the backward
        pass."""
        per = self.kernel_launches_per_forward()
        rm = self.remat
        return {"mamba_fused_scan": {"fwd": per["mamba_fused_scan"],
                                     "bwd": per["mamba_fused_scan"]},
                "tap_conv": {"fwd": per["tap_conv"] * (2 if rm else 1),
                             "bwd": per["tap_conv"]}}
