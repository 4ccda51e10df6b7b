"""UM_Net, the DSConv-based predecessor of MM_Net, in PyTorch (counterpart
of `mm_unet_tpu/models/um_net.py`): a ResNet-34 encoder, 1x1 channel
reducers, the CBAM contour branch, three RCGs with a single-direction
Mamba detour, DSConv decoder and side-output blocks, the HPPF pyramid
head, and as output the final head plus the contour map and the four side
outputs, each bilinearly upsampled (align_corners=True) to the input size.
SELayer, NonLocalBlock and ALGM are here as the JAX package has them; the
active forward, like the reference's, does not use them.

f32 only: the JAX UM_Net has no reduced-precision feature path. `.eval()`
is the JAX model's `train=False`; `.train()` normalises with the batch
statistics and draws the two Dropout2d sites' masks (rate 0.1, as fixed in
the JAX model). Every DSConv is morph 0, so its sample and conv run as one
tap-conv (kernels 3/4 on the card), and each RCG's Mamba (d_model 64,
`bimamba_type="none"`) takes the megakernel route (kernels 1/2) unless its
`scan_impl` is set.

Module and parameter names are the torch reference's, as tabulated by
`mm_unet_tpu.utils.torch_convert.um_net_pairs` (encoder1_conv, encoder2.0.conv1,
down3.0, decoder5.conv1.0, side5, cbam.3, rcg4.mamba, hpp.conv1.0, final.4,
...), so `utils.convert` maps JAX variables onto this model.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.dsconv import DSConv
from mm_unet_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    Dropout2d,
    init_flax_style,
    lecun_normal_,
    nchw_to_nhwc,
    nhwc_to_nchw,
    resize_bilinear_align_corners,
)
from mm_unet_tpu_torch.models.mamba import Mamba, kernel_launches
from mm_unet_tpu_torch.models.mm_unet import CBAM
from mm_unet_tpu_torch.models.resnet import resnet_stage


def _dsconv_bn_relu(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(DSConv(cin, cout), BatchNorm2d(cout), nn.ReLU())


class SELayer(nn.Module):
    """Squeeze-and-excitation: channel means -> Linear(c/r) -> ReLU ->
    Linear(c) -> sigmoid, scaling the channels."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channel, channel // reduction, bias=False), nn.ReLU(),
                                nn.Linear(channel // reduction, channel, bias=False), nn.Sigmoid())
        for lin in (self.fc[0], self.fc[2]):  # flax Dense: lecun-normal kernels
            lecun_normal_(lin.weight, lin.in_features, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean((2, 3)))[:, :, None, None]


class NonLocalBlock(nn.Module):
    """Non-local attention with DSConv projections (g, phi, theta; g and phi
    max-pooled 2x2 when `sub_sample`), softmax over the pooled positions,
    then a DSConv + BatchNorm back to the input width, plus the input."""

    def __init__(self, in_channels: int, sub_sample: bool = True):
        super().__init__()
        inter = max(in_channels // 2, 1)
        self.sub_sample = sub_sample
        self.g = DSConv(in_channels, inter)
        self.phi = DSConv(in_channels, inter)
        self.theta = DSConv(in_channels, inter)
        self.W = nn.Sequential(DSConv(inter, in_channels), BatchNorm2d(in_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        g, phi, theta = self.g(x), self.phi(x), self.theta(x)
        if self.sub_sample:
            g, phi = F.max_pool2d(g, 2), F.max_pool2d(phi, 2)

        def tokens(t):  # (B, C, H, W) -> (B, H*W, C), positions row-major
            return nchw_to_nhwc(t).reshape(b, -1, t.shape[1])

        att = torch.softmax(tokens(theta) @ tokens(phi).transpose(1, 2), dim=-1)
        y = nhwc_to_nchw((att @ tokens(g)).reshape(b, h, w, -1))
        return self.W(y) + x


class HPPF(nn.Module):
    """Pyramid pooling attention head over (d2, d3 and d4 resized to d2's
    size): global mean, a DSConv of the 4x4 max pool and a 1x1 conv of the
    8x8 max pool, each flattened channel-major to the full width, averaged,
    squeezed and excited into a channel attention, then a 3x3 conv + BN +
    ReLU to a third of the width. The map must be at least 8x8."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.conv1 = nn.Sequential(DSConv(c, c // 16), nn.ReLU())
        self.conv2 = nn.Sequential(Conv2d(c, c // 64, 1), nn.ReLU())
        self.mlp = nn.Sequential(Conv2d(c, c // 8, 1), nn.ReLU(), Conv2d(c // 8, c, 1),
                                 nn.Sigmoid())
        self.feat_conv = nn.Sequential(Conv2d(c, c // 3, 3, padding=1), BatchNorm2d(c // 3),
                                       nn.ReLU())

    def forward(self, x1, x2, x3):
        hw = x1.shape[2:]
        feat = torch.cat([x1, resize_bilinear_align_corners(x2, hw),
                          resize_bilinear_align_corners(x3, hw)], dim=1)
        b, c, h, w = feat.shape
        y1 = feat.mean((2, 3), keepdim=True)
        m1 = F.max_pool2d(feat, (h // 4, w // 4))
        m2 = F.max_pool2d(feat, (h // 8, w // 8))
        # NCHW flattened: the reference's y.reshape(b, c, 1, 1), channel-major
        y2 = self.conv1(m1).reshape(b, c, 1, 1)
        y3 = self.conv2(m2).reshape(b, c, 1, 1)
        att = self.mlp((y1 + y2 + y3) / 3.0)
        return self.feat_conv(att * feat)


class ALGM(nn.Module):
    """Local-global pyramid module: a 3x3 conv to mid_ch/4, a NonLocalBlock
    and three dilated 3x3 convs (dilations `pool_size`) over growing
    concatenations, then per entry of `out_list` an SELayer and a 3x3 conv
    (with `cascade` and guidance maps `y`, plus a conv of |resize(y[j]) - o|).
    Its input has `mid_ch` channels. Every conv is followed by BN + ReLU."""

    def __init__(self, mid_ch: int, pool_size: Sequence[int], out_list: Sequence[int],
                 cascade: bool = False):
        super().__init__()
        c = mid_ch // 4
        self.cascade = cascade

        def cbr(cin, cout, d=1):
            return nn.Sequential(Conv2d(cin, cout, 3, padding=d, dilation=d), BatchNorm2d(cout),
                                 nn.ReLU())

        self.conv_in = cbr(mid_ch, c)
        self.non_local = NonLocalBlock(c)
        self.dilated = nn.ModuleList(cbr(c * (i + 1), c, d) for i, d in enumerate(pool_size))
        self.outs = nn.ModuleList(nn.Sequential(SELayer(4 * c), *cbr(4 * c, oc))
                                  for oc in out_list)
        self.guides = nn.ModuleList(cbr(oc, 64) for oc in out_list) if cascade else None

    def forward(self, x, y=None):
        h = self.conv_in(x)
        ctx = [self.non_local(h), self.dilated[0](h)]
        ctx.append(self.dilated[1](torch.cat([h, ctx[0]], dim=1)))
        ctx.append(self.dilated[2](torch.cat([h, ctx[1], ctx[2]], dim=1)))
        lg = torch.cat(ctx, dim=1)
        outs = []
        for j, head in enumerate(self.outs):
            o = head(lg)
            if self.cascade and y is not None:
                guide = resize_bilinear_align_corners(y[j], x.shape[2:])
                o = o + self.guides[j]((guide - o).abs())
            outs.append(o)
        return outs


class RCG(nn.Module):
    """Reverse-context gating: DSConv fuse of the upsampled edge map and the
    reverse-attended feature, a single-direction Mamba over its tokens at
    twice the resolution, gated back onto the feature."""

    def __init__(self, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _dsconv_bn_relu(128, 64)
        self.upsample = ConvTranspose2d(64, 64, 4, stride=2, padding=1)
        self.mamba = Mamba(d_model=64, d_state=d_state, d_conv=d_conv, expand=expand,
                           bimamba_type="none", generator=generator)
        self.downsample = Conv2d(64, 64, 4, stride=2, padding=1)
        self.mlp = nn.Sequential(Conv2d(64, 1, 1), nn.Sigmoid())

    def forward(self, pre, edge, f):
        r = (1.0 - torch.sigmoid(pre)) * f
        x2 = self.conv1(torch.cat([resize_bilinear_align_corners(edge, f.shape[2:]), r], dim=1))
        x0 = self.upsample(x2)
        b, c, h2, w2 = x0.shape
        out = self.mamba(nchw_to_nhwc(x0).reshape(b, h2 * w2, c))
        out = nhwc_to_nchw(out.reshape(b, h2, w2, c))
        return self.downsample(out) * self.mlp(x2) * x2 + f


class DecoderBlock(nn.Module):
    """Two DSConvs (to in/4, then out channels) + 2x bilinear upsample."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = _dsconv_bn_relu(in_channels, in_channels // 4)
        self.conv2 = _dsconv_bn_relu(in_channels // 4, out_channels)

    def forward(self, x):
        x = self.conv2(self.conv1(x))
        return resize_bilinear_align_corners(x, (x.shape[2] * 2, x.shape[3] * 2))


class SideoutBlock(nn.Module):
    """DSConv -> BN -> ReLU -> Dropout2d(0.1) -> 1x1 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = _dsconv_bn_relu(in_channels, in_channels // 4)
        self.drop = Dropout2d(0.1)
        self.conv2 = Conv2d(in_channels // 4, out_channels, 1)

    def forward(self, x):
        return self.conv2(self.drop(self.conv1(x)))


class UM_Net(nn.Module):
    """(B, 3, H, W) -> (B, num_classes, H, W) f32 logits; H and W multiples
    of 32 (HPPF pools its H/2 map 8x8). `num_slices_list`, `out_indices` and
    `heads` are the JAX constructor's configuration keys, unused by its
    forward as by this one."""

    def __init__(self, num_classes: int = 1,
                 num_slices_list: Sequence[int] = (64, 32, 16, 8),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 heads: Sequence[int] = (1, 2, 4, 4),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.num_slices_list, self.out_indices, self.heads = (
            tuple(num_slices_list), tuple(out_indices), tuple(heads))
        self.encoder1_conv = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.encoder1_bn = BatchNorm2d(64)
        for i, (cin, w, n) in enumerate(((64, 64, 3), (64, 128, 4), (128, 256, 6),
                                         (256, 512, 3))):
            self.add_module(f"encoder{i + 2}", resnet_stage(cin, w, n, 2 if i else 1))
        for i, cin in ((3, 128), (4, 256), (5, 512)):
            self.add_module(f"down{i}", nn.Sequential(Conv2d(cin, 64, 1), BatchNorm2d(64),
                                                      nn.ReLU()))
        self.decoder5 = DecoderBlock(64, 64)
        self.side5 = SideoutBlock(64, num_classes)
        self.cbam = nn.Sequential(
            Conv2d(64, 64, 3, padding=1), BatchNorm2d(64), nn.ReLU(), CBAM(64),
            Conv2d(64, 64, 3, padding=1), BatchNorm2d(64), nn.ReLU(),
        )
        self.line_predict = Conv2d(64, 1, 3, padding=1)
        for n in (4, 3, 2):
            self.add_module(f"rcg{n}", RCG(generator=g))
            self.add_module(f"decoder{n}", DecoderBlock(128, 64))
            self.add_module(f"side{n}", SideoutBlock(64, num_classes))
        self.hpp = HPPF(192)
        self.final = nn.Sequential(Conv2d(64, 32, 3, padding=1), BatchNorm2d(32), nn.ReLU(),
                                   Dropout2d(0.1), Conv2d(32, num_classes, 1))
        init_flax_style(self, g)

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw every Dropout2d mask from `generator` (on the model's device)."""
        for m in self.modules():
            if isinstance(m, Dropout2d):
                m.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_hw = x.shape[2:]
        e1 = F.relu(self.encoder1_bn(self.encoder1_conv(x)))
        e2 = self.encoder2(F.max_pool2d(e1, 3, 2, 1))
        l2 = self.encoder3(e2)
        l3 = self.encoder4(l2)
        l4 = self.encoder5(l3)
        e3, e4, e5 = self.down3(l2), self.down4(l3), self.down5(l4)

        d5 = self.decoder5(e5)
        out5 = self.side5(d5)
        c1 = self.cbam(e1)
        p_c = self.line_predict(c1)

        r4 = self.rcg4(out5, c1, e4)
        d4 = self.decoder4(torch.cat([d5, r4], dim=1))
        out4 = self.side4(d4)
        r3 = self.rcg3(out4, c1, e3)
        d3 = self.decoder3(torch.cat([d4, r3], dim=1))
        out3 = self.side3(d3)
        r2 = self.rcg2(out3, c1, e2)
        d2 = self.decoder2(torch.cat([d3, r2], dim=1))
        out2 = self.side2(d2)

        out1 = self.final(self.hpp(d2, d3, d4))
        return sum(resize_bilinear_align_corners(o, in_hw)
                   for o in (out1, out2, out3, out4, out5, p_c))

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """Launches of each kernel one forward makes, counted from the
        modules: one fused scan per RCG Mamba (or one grouped selective scan
        on the other route), one tap-conv per DSConv (all morph 0)."""
        dsconvs = sum(isinstance(m, DSConv) and m.morph == 0 for m in self.modules())
        return {**kernel_launches(self), "tap_conv": dsconvs}

    def kernel_launches_per_train_step(self) -> dict:
        """Forward and backward launches of each kernel in one train step:
        every launch of the forward has its backward."""
        return {name: {"fwd": n, "bwd": n}
                for name, n in self.kernel_launches_per_forward().items()}
