"""Shared layers (counterpart of `mm_unet_tpu/models/layers.py`).

The port's modules are NCHW, PyTorch's habit; `nchw_to_nhwc` and
`nhwc_to_nchw` cross to the NHWC layout of the kernels' public functions.

Compute dtype rule of the reference (`mm_unet._lkw`): a layer built with
`compute_dtype` (bf16 in the serving configuration) runs its convolution in
that dtype; without one it runs in the promotion of input and weight dtypes,
as flax does. Parameters and norm statistics keep their own dtype; norms
reduce in f32 and return the compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.ops.grid_sample import grid_sample_bilinear
from mm_unet_tpu_torch.ops.tap_conv import tap_conv


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True (the function the
    reference builds from two interpolation matrices, `layers.py:67`)."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


def grid_sample_bilinear_nhwc(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """NHWC form of `ops.grid_sample.grid_sample_bilinear` (bilinear, zeros
    padding, align_corners=True): feat (B, H, W, C), grid (B, Hg, Wg, 2) xy
    in [-1, 1]; returns (B, Hg, Wg, C)."""
    return nchw_to_nhwc(grid_sample_bilinear(nhwc_to_nchw(feat), grid))


def sample_at(feat: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of NHWC `feat` (B, H, W, C) at row and column
    coordinates y, x (B, Hg, Wg), each clamped to the map, as the
    reference's deformable convs take them: (B, Hg, Wg, C)."""
    h, w = feat.shape[1:3]
    y_s = y.clamp(0, h - 1) * (2.0 / max(h - 1, 1)) - 1.0
    x_s = x.clamp(0, w - 1) * (2.0 / max(w - 1, 1)) - 1.0
    return grid_sample_bilinear_nhwc(feat, torch.stack([x_s, y_s], dim=-1))


def row_sample_conv(feat: torch.Tensor, y: torch.Tensor, conv: nn.Conv2d,
                    gn: nn.Module) -> torch.Tensor:
    """Morph 0 of the deformable convs (MMConv, DSConv): NHWC `feat` (B, H,
    W, C) sampled at f32 row coordinates y (B, H, W, K), tap j at column
    clamp(w + j - K//2), and `conv`'s (K,1) stride-(K,1) conv, fused in one
    `tap_conv`; then `gn`. NCHW out."""
    k = conv.weight.shape[2]
    kernel = conv.weight.permute(2, 3, 1, 0)  # (F,C,K,1) -> (K,1,C,F)
    out = tap_conv(feat, y, kernel, conv.bias, [j - k // 2 for j in range(k)])
    return gn(nhwc_to_nchw(out))


def grid_sample_conv(feat: torch.Tensor, y: torch.Tensor, x: torch.Tensor, conv: nn.Module,
                     gn: nn.Module) -> torch.Tensor:
    """Morph 1 of the deformable convs: NHWC `feat` sampled at (y, x) (B,
    Hg, Wg) by `sample_at`, then `conv` and `gn`. NCHW out."""
    return gn(conv(nhwc_to_nchw(sample_at(feat, y, x))))


def resize_linear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """NCHW linear upsampling with half-pixel centres, `jax.image.resize(...,
    "linear")` (dkDualNet's `_up`; for upsampling its antialiasing is a
    no-op and its edge renormalisation equals clamping the source
    coordinate, so this is `F.interpolate(align_corners=False)`)."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    if any(o < i for o, i in zip(out_hw, x.shape[2:])):
        raise ValueError(f"resize_linear upsamples only: {tuple(x.shape[2:])} -> {tuple(out_hw)}")
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)


def resize_bilinear_torch(x: torch.Tensor, out_hw) -> torch.Tensor:
    """NCHW bilinear resize with half-pixel centres and no antialiasing,
    up or down: the torch reference's `F.interpolate(..., "bilinear")`
    (the JAX package's `layers.resize_bilinear_torch`)."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)


def _rdtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a norm reduces in: f32, or f64 for an f64 input."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _cdtype(compute_dtype: Optional[torch.dtype], x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    return compute_dtype or torch.promote_types(x.dtype, w.dtype)


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cd = _cdtype(self.compute_dtype, x, self.weight)
        bias = None if self.bias is None else self.bias.to(cd)
        return self._conv_forward(x.to(cd), self.weight.to(cd), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cd = _cdtype(self.compute_dtype, x, self.weight)
        bias = None if self.bias is None else self.bias.to(cd)
        return F.conv_transpose2d(x.to(cd), self.weight.to(cd), bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm reduced in f32 (f64 inputs in f64), as flax's
    `BatchNorm(momentum=0.9)`.

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch mean and the biased batch variance E[x^2] - E[x]^2
    (clipped at 0, flax's fast variance) and updates the running statistics
    in place as flax does, running = 0.9 * running + 0.1 * batch, with the
    biased variance (`F.batch_norm` would store the unbiased one). Under data
    parallelism (`sync`, a `parallel.mesh.DataParallel`) the batch
    statistics are the global batch's."""

    MOMENTUM = 0.9  # flax's convention: the weight of the old running value

    def __init__(self, num_features: int, compute_dtype: Optional[torch.dtype] = None,
                 eps: float = 1e-5):
        super().__init__(num_features, eps=eps)
        self.compute_dtype = compute_dtype
        self.sync = None

    def forward(self, x):
        cd, rd = _cdtype(self.compute_dtype, x, self.weight), _rdtype(x)
        xf = x.to(rd)
        if not self.training:
            y = F.batch_norm(xf, self.running_mean.to(rd), self.running_var.to(rd),
                             self.weight.to(rd), self.bias.to(rd), False, 0.0, self.eps)
            return y.to(cd)
        if self.sync is None:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
        else:
            mean, var = self.sync.batch_moments(xf, (0, 2, 3))
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_(mean.detach().to(self.running_mean.dtype), alpha=1 - m)
            self.running_var.mul_(m).add_(var.detach().to(self.running_var.dtype), alpha=1 - m)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(rd)
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias.to(rd)[:, None, None]
        return y.to(cd)


def _uniform(layer: nn.Module, shape: tuple, x: torch.Tensor) -> torch.Tensor:
    """U(0, 1) draws of `shape` (leading axis: x's batch) from the layer's
    generator on x's device. Under data parallelism (`layer.sync`) they are
    drawn for the global batch and this rank keeps its rows, so that the
    masks do not depend on the world size."""
    world = 1 if layer.sync is None else layer.sync.world
    u = torch.rand((shape[0] * world, *shape[1:]), generator=layer.generator, device=x.device)
    return u if layer.sync is None else layer.sync.local_rows(u)


class Dropout2d(nn.Module):
    """Channel dropout in train mode: each (sample, channel) plane is kept
    with probability 1 - p and scaled by 1 / (1 - p), or zeroed (flax's
    `Dropout(p, broadcast_dims=(1, 2))` on NHWC). The keep mask is drawn
    from `generator` (a `torch.Generator` on the input's device) when one is
    set, else from PyTorch's default generator. Identity in eval mode or at
    p = 0."""

    def __init__(self, p: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = p
        self.generator = generator
        self.sync = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        u = _uniform(self, (x.shape[0], x.shape[1], 1, 1), x)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """Element dropout in train mode: each element is kept with probability
    1 - p and scaled by 1 / (1 - p), or zeroed (flax's `Dropout(p)`). The
    keep mask is drawn from `generator` (a `torch.Generator` on the input's
    device) when one is set. Identity in eval mode or at p = 0."""

    def __init__(self, p: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = p
        self.generator = generator
        self.sync = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        u = _uniform(self, x.shape, x)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth in train mode: each sample's branch is kept with
    probability 1 - p and scaled by 1 / (1 - p), or zeroed (dkDualNet's
    `dp`, `dkdualnet.py:70-77`). The keep mask is drawn from `generator` (a
    `torch.Generator` on the input's device) when one is set. Identity in
    eval mode or at p = 0."""

    def __init__(self, p: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = p
        self.generator = generator
        self.sync = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        u = _uniform(self, (x.shape[0], *([1] * (x.ndim - 1))), x)
        return x * (u < keep).to(x.dtype) / keep


class Linear(nn.Linear):
    """`nn.Linear` that `init_flax_style` initialises as flax's `Dense`."""


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              bias: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale + bias + mask) v over (..., tokens, head_dim)
    operands: the attention of the zoo's transformers, as the JAX package
    computes it in XLA. `bias` and `mask` are additive and broadcast
    against the (..., q tokens, k tokens) logits."""
    att = torch.matmul(q, k.transpose(-2, -1)) * scale
    if bias is not None:
        att = att + bias
    if mask is not None:
        att = att + mask
    return torch.matmul(att.softmax(dim=-1), v)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last (channel) axis, reduced in f32 (f64 inputs in
    f64) and returned in the promotion of input and weight dtypes (flax's
    `LayerNorm`)."""

    def __init__(self, num_features: int, eps: float):
        super().__init__(num_features, eps=eps)

    def forward(self, x):
        rd = _rdtype(x)
        y = F.layer_norm(x.to(rd), self.normalized_shape, self.weight.to(rd), self.bias.to(rd),
                         self.eps)
        return y.to(_cdtype(None, x, self.weight))


class GroupNorm(nn.GroupNorm):
    """GroupNorm reduced in f32 (f64 inputs in f64; eps 1e-5, the torch
    reference's)."""

    def __init__(self, num_groups: int, num_channels: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(num_groups, num_channels, eps=1e-5)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cd = _cdtype(self.compute_dtype, x, self.weight)
        rd = _rdtype(x)
        y = F.group_norm(x.to(rd), self.num_groups, self.weight.to(rd), self.bias.to(rd),
                         self.eps)
        return y.to(cd)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `lecun_normal`: truncated normal (+-2 sd) with variance 1/fan_in,
    drawn from `generator` (PyTorch's default generator when None)."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(std)
    return t


def init_flax_style(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise this module's convolutions and `Linear`s as flax does
    by default: lecun-normal kernels with fan_in = in_channels * kernel
    area (in_features), zero biases. (Norms already start at weight 1, bias
    0, mean 0, var 1.)"""
    for m in module.modules():
        if isinstance(m, Linear):
            lecun_normal_(m.weight, m.in_features, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and type(m).__module__ == __name__:
            w = m.weight
            area = w.shape[2] * w.shape[3]
            fan_in = area * (w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1])
            lecun_normal_(w, fan_in, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
