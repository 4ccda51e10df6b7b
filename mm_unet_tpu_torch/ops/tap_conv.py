"""Morph-0 tap-conv forward: MMConv's deformable row sample fused with its
(k, 1) stride-k convolution.

Counterpart of `mm_unet_tpu/ops/tap_conv.py::tap_conv` (forward only), in the
same layout: feat (B, H, W, C), y (B, H, W, K) f32 row coordinates, kernel
(K, 1, C, F), bias (F,). Tap j reads column clamp(w + x_shifts[j], 0, W-1)
at row coordinate clip(y, 0, H-1), interpolating linearly between rows
lo = clip(floor(yc), 0, H-2) and lo + 1.

`tap_conv` launches the CUDA kernel `csrc/tap_conv_fwd.cu` for CUDA tensors
and takes the plain `tap_conv_ref` for CPU tensors; `tap_conv.launches`
counts kernel launches. Under a bf16 stream both round the sampled taps and
the kernel to bf16 before the f32-accumulated projection, and round the
output.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

_STREAM_DTYPES = (torch.float32, torch.bfloat16)


def _taps_index(y_coords: torch.Tensor, h: int):
    """(lo, hi, frac) for the row lerp: lo/hi int64, frac f32."""
    yc = y_coords.float().clamp(0, h - 1)
    lo = torch.floor(yc).clamp(0, max(h - 2, 0))
    frac = yc - lo
    lo = lo.long()
    return lo, (lo + 1).clamp(max=h - 1), frac


def tap_conv_ref(feat, y_coords, kernel, bias, x_shifts: Sequence[int]) -> torch.Tensor:
    """Plain version: per tap, a column-shifted row gather and lerp, then an
    f32 projection; (B, H, W, F) in feat's dtype."""
    b, h, w, c = feat.shape
    sd = feat.dtype
    lo, hi, frac = _taps_index(y_coords, h)
    kb = kernel.to(sd).float()
    acc = None
    for j, dx in enumerate(x_shifts):
        cols = (torch.arange(w, device=feat.device) + int(dx)).clamp(0, w - 1)
        xs = feat[:, :, cols]  # (B, H, W, C) column-shifted source
        idx = lambda r: r[..., j : j + 1].expand(b, h, w, c)  # noqa: E731
        v_lo = torch.gather(xs, 1, idx(lo)).float()
        v_hi = torch.gather(xs, 1, idx(hi)).float()
        fr = frac[..., j : j + 1]
        tap = (v_lo * (1.0 - fr) + v_hi * fr).to(sd).float()
        prj = tap @ kb[j, 0]
        acc = prj if acc is None else acc + prj
    return (acc + bias.float()).to(sd)


def tap_conv(
    feat: torch.Tensor,      # (B, H, W, C)
    y_coords: torch.Tensor,  # (B, H, W, K) row coordinates
    kernel: torch.Tensor,    # (K, 1, C, F)
    bias: torch.Tensor,      # (F,)
    x_shifts: Sequence[int],  # K column shifts
) -> torch.Tensor:
    """(B, H, W, F) in feat's dtype (f32 or bf16)."""
    if feat.device.type == "cpu":
        return tap_conv_ref(feat, y_coords, kernel, bias, x_shifts)
    if feat.device.type != "cuda":
        raise ValueError(f"tap_conv: no kernel for device {feat.device}")
    from mm_unet_tpu_torch import _build

    b, h, w, c = feat.shape
    k, f = y_coords.shape[-1], kernel.shape[-1]
    if feat.dtype not in _STREAM_DTYPES:
        raise TypeError(f"tap_conv: stream dtype {feat.dtype} not in {_STREAM_DTYPES}")
    if y_coords.shape != (b, h, w, k) or kernel.shape != (k, 1, c, f) or len(x_shifts) != k:
        raise ValueError("tap_conv: inconsistent shapes")
    if not 1 <= k <= 9 or feat.numel() >= 2**31:
        raise ValueError("tap_conv: the kernel takes 1..9 taps and < 2^31 feature elements")
    sd, dev = feat.dtype, feat.device
    feat = feat.contiguous()
    yc = y_coords.to(dev).float().contiguous()
    kb = kernel.to(dev).to(sd).float().reshape(k * c, f).contiguous()
    bs = bias.to(dev).float().contiguous()
    shifts = (ctypes.c_int * k)(*(int(s) for s in x_shifts))
    out = torch.empty(b, h, w, f, dtype=sd, device=dev)
    err = _build.library().tap_conv_fwd(
        feat.data_ptr(), yc.data_ptr(), kb.data_ptr(), bs.data_ptr(),
        ctypes.addressof(shifts), out.data_ptr(), b, h, w, c, f, k,
        int(sd == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "tap_conv_fwd")
    tap_conv.launches += 1
    return out


tap_conv.launches = 0
