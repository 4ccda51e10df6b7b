"""Morph-0 tap-conv: MMConv's deformable row sample fused with its (k, 1)
stride-k convolution, and its backward.

Counterpart of `mm_unet_tpu/ops/tap_conv.py::tap_conv`, in the same
layout: feat (B, H, W, C), y (B, H, W, K) f32 row coordinates, kernel
(K, 1, C, F), bias (F,). Tap j reads column clamp(w + x_shifts[j], 0, W-1)
at row coordinate clip(y, 0, H-1), interpolating linearly between rows
lo = clip(floor(yc), 0, H-2) and lo + 1.

`tap_conv` launches the CUDA kernels for CUDA tensors: `csrc/tap_conv_fwd.cu`
forward and, through a `torch.autograd.Function`, `csrc/tap_conv_bwd.cu`
backward. For CPU tensors it takes the plain `tap_conv_ref`, differentiated
by autograd. `tap_conv.launches` and `.bwd_launches` count kernel launches.
Under a bf16 stream both round the sampled taps and the kernel to bf16
before the f32-accumulated projection (on the tensor cores), and round the
output. The backward sums the feature gradient for a strip of columns over
all H rows in shared memory, so it takes maps of up to ~1,600 rows (f32, 9
taps) to ~2,500 (bf16, 3 taps) and raises on taller ones.
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


def _prepare(feat, y_coords, kernel, bias, x_shifts):
    """Check the shapes and bring the operands into the kernels' layouts:
    (feat contiguous, y f32, kernel (K*C, F) in the stream dtype, bias f32,
    shifts as a C int array)."""
    b, h, w, c = feat.shape
    k, f = y_coords.shape[-1], kernel.shape[-1]
    if feat.dtype not in _STREAM_DTYPES:
        raise TypeError(f"tap_conv: stream dtype {feat.dtype} not in {_STREAM_DTYPES}")
    if y_coords.shape != (b, h, w, k) or kernel.shape != (k, 1, c, f) or len(x_shifts) != k:
        raise ValueError("tap_conv: inconsistent shapes")
    if not 1 <= k <= 9 or feat.numel() >= 2**31:
        raise ValueError("tap_conv: the kernel takes 1..9 taps and < 2^31 feature elements")
    dev = feat.device
    yc = y_coords.to(dev).float().contiguous()
    kb = kernel.to(dev).to(feat.dtype).reshape(k * c, f).contiguous()
    shifts = (ctypes.c_int * k)(*(int(s) for s in x_shifts))
    return feat.contiguous(), yc, kb, bias.to(dev).float().contiguous(), shifts


def _launch_fwd(feat, yc, kb, bias, shifts):
    from mm_unet_tpu_torch import _build

    b, h, w, c = feat.shape
    k, f = yc.shape[-1], kb.shape[-1]
    out = torch.empty(b, h, w, f, dtype=feat.dtype, device=feat.device)
    err = _build.library().tap_conv_fwd(
        feat.data_ptr(), yc.data_ptr(), kb.data_ptr(), bias.data_ptr(),
        ctypes.addressof(shifts), out.data_ptr(), b, h, w, c, f, k,
        int(feat.dtype == torch.bfloat16), torch.cuda.current_stream(feat.device).cuda_stream,
    )
    _build.check(err, "tap_conv_fwd")
    tap_conv.launches += 1
    return out


# the backward kernel's dkernel tile (K*C rows x features), as it dispatches
def _dkernel_tile(f: int) -> tuple[int, int]:
    return (128, 16) if f <= 16 else (128, 32) if f <= 32 else (64, 64)


def _launch_bwd(dout, feat, yc, kb, shifts):
    """(dfeat in the stream dtype, dy f32, dkernel (K*C, F) f32, dbias f32):
    the backward kernels, which also sum dkernel's per-slice partials and
    dbias; kb is the kernel (K*C, F) in the stream dtype."""
    from mm_unet_tpu_torch import _build

    b, h, w, c = feat.shape
    k, f = yc.shape[-1], kb.shape[-1]
    dev, m = feat.device, b * h * w
    # pixels per dkernel slice: enough blocks to fill the card several times
    bm, bn = _dkernel_tile(f)
    tiles = -(-(k * c) // bm) * -(-f // bn)
    splits = max(1, min(-(-m // 256), -(-528 // tiles)))
    per_split = -(-m // splits)
    ms = -(-per_split // 32) * 32  # a whole number of the kernel's 32-pixel steps
    splits = -(-m // ms)
    dout = dout.to(feat.dtype).contiguous()
    dfeat = torch.empty_like(feat)
    dy = torch.empty(b, h, w, k, device=dev)
    dk, db = torch.empty(k * c, f, device=dev), torch.empty(f, device=dev)
    p_dk, p_db = torch.empty(splits, k * c, f, device=dev), torch.empty(splits, f, device=dev)
    err = _build.library().tap_conv_bwd(
        feat.data_ptr(), yc.data_ptr(), kb.data_ptr(), ctypes.addressof(shifts),
        dout.data_ptr(), dfeat.data_ptr(), dy.data_ptr(), dk.data_ptr(), db.data_ptr(),
        p_dk.data_ptr(), p_db.data_ptr(), b, h, w, c, f, k, ms,
        int(feat.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "tap_conv_bwd")
    tap_conv.bwd_launches += 1
    return dfeat, dy, dk, db


class _TapConvFn(torch.autograd.Function):
    """The CUDA forward kernel and, for its backward, `tap_conv_bwd`'s C
    function: a memset of dy and three kernels give dfeat, dy, dkernel and
    dbias, with no reduction in the wrapper. The kernel's gradient comes
    back f32 and unrounded, as the JAX kernel keeps its f32 parameter into
    the core."""

    @staticmethod
    def forward(ctx, feat, y_coords, kernel, bias, x_shifts):
        feat_c, yc, kb, bs, shifts = _prepare(feat, y_coords, kernel, bias, x_shifts)
        ctx.save_for_backward(feat_c, yc, kb)
        ctx.shifts, ctx.kernel_shape = shifts, kernel.shape
        ctx.dtypes = (y_coords.dtype, kernel.dtype, bias.dtype)
        return _launch_fwd(feat_c, yc, kb, bs, shifts)

    @staticmethod
    def backward(ctx, dout):
        feat, yc, kb = ctx.saved_tensors
        dfeat, dy, dk, dbias = _launch_bwd(dout, feat, yc, kb, ctx.shifts)
        y_dtype, k_dtype, b_dtype = ctx.dtypes
        return (dfeat, dy.to(y_dtype), dk.reshape(ctx.kernel_shape).to(k_dtype),
                dbias.to(b_dtype), None)


def tap_conv(
    feat: torch.Tensor,      # (B, H, W, C)
    y_coords: torch.Tensor,  # (B, H, W, K) row coordinates
    kernel: torch.Tensor,    # (K, 1, C, F)
    bias: torch.Tensor,      # (F,)
    x_shifts: Sequence[int],  # K column shifts
) -> torch.Tensor:
    """(B, H, W, F) in feat's dtype (f32 or bf16); differentiable w.r.t.
    feat, y_coords, kernel and bias."""
    if feat.device.type == "cpu":
        return tap_conv_ref(feat, y_coords, kernel, bias, x_shifts)
    if feat.device.type != "cuda":
        raise ValueError(f"tap_conv: no kernel for device {feat.device}")
    return _TapConvFn.apply(feat, y_coords, kernel, bias, tuple(int(s) for s in x_shifts))


tap_conv.launches = 0
tap_conv.bwd_launches = 0
