"""Fused Mamba-inner forward: causal conv + SiLU, x_proj, dt_proj + softplus,
selective scan and silu(z) gate over the packed in_proj output.

Counterpart of `mm_unet_tpu/ops/mamba_fused.py::mamba_fused_scan` (forward
only), in the same layout: xz (B, G, 2D, L) with the scan stream in rows
[0, D) and the gate in rows [D, 2D). `mamba_fused_scan` launches the CUDA
kernel `csrc/mamba_fused_fwd.cu` for CUDA tensors and takes the plain
`mamba_fused_scan_ref` for CPU tensors; `mamba_fused_scan.launches` counts
kernel launches.

Under a bf16 stream both versions round where the TPU kernel rounds: the
weights fed to the conv and the projections, the conv output, the dt rows of
x_dbl, and the gated output. The state and every sum stay f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from mm_unet_tpu_torch.ops.causal_conv1d import causal_conv1d
from mm_unet_tpu_torch.ops.selective_scan import selective_scan_ref

_STREAM_DTYPES = (torch.float32, torch.bfloat16)


def mamba_fused_scan_ref(xz, conv_w, conv_b, x_proj, dt_w, dt_b, A, D_skip,
                         reverse: bool = False) -> torch.Tensor:
    """Plain version: per group, causal conv -> einsum projections ->
    `selective_scan_ref` -> gate. The reverse direction flips, scans and
    flips back."""
    sd = xz.dtype
    _, G, D2, _ = xz.shape
    D, R, N = D2 // 2, dt_w.shape[2], A.shape[2]
    outs = []
    for g in range(G):
        x, z = xz[:, g, :D], xz[:, g, D:]
        if reverse:
            x, z = x.flip(-1), z.flip(-1)
        bias = None if conv_b is None else conv_b[g].float()
        u = causal_conv1d(x, conv_w[g].to(sd), bias, activation="silu").float()
        xdbl = torch.einsum("ed,bdl->bel", x_proj[g].to(sd).float(), u)
        dt = torch.einsum("dr,brl->bdl", dt_w[g].to(sd).float(), xdbl[:, :R].to(sd).float())
        y = selective_scan_ref(
            u, dt, A[g], xdbl[:, R : R + N], xdbl[:, R + N :], D=D_skip[g], z=z,
            delta_bias=dt_b[g], delta_softplus=True,
        ).to(sd)
        outs.append(y.flip(-1) if reverse else y)
    return torch.stack(outs, dim=1)


def _chunk_len(D: int, E: int) -> int:
    """Tokens per block: the largest power of two in [16, 256] whose f32
    shared-memory tile (u and dt for D channels, E x_dbl rows) fits 96 KB
    for wide Mambas (two blocks per SM) or 24 KB for narrow ones (many small
    blocks per SM, to hide the scan's latency)."""
    budget = (96 if D > 32 else 24) * 1024
    t = 256
    while t > 16 and (2 * D + E) * t * 4 > budget:
        t //= 2
    return t


def mamba_fused_scan(
    xz: torch.Tensor,               # (B, G, 2D, L) packed in_proj output
    conv_w: torch.Tensor,           # (G, D, W)
    conv_b: Optional[torch.Tensor],  # (G, D) or None
    x_proj: torch.Tensor,           # (G, R + 2N, D)
    dt_w: torch.Tensor,             # (G, D, R)
    dt_b: torch.Tensor,             # (G, D)
    A: torch.Tensor,                # (G, D, N), negative
    D_skip: torch.Tensor,           # (G, D)
    reverse: bool = False,
) -> torch.Tensor:
    """(B, G, D, L) gated scan outputs in xz's dtype (f32 or bf16)."""
    if xz.device.type == "cpu":
        return mamba_fused_scan_ref(xz, conv_w, conv_b, x_proj, dt_w, dt_b, A, D_skip, reverse)
    if xz.device.type != "cuda":
        raise ValueError(f"mamba_fused_scan: no kernel for device {xz.device}")
    from mm_unet_tpu_torch import _build

    Bsz, G, D2, L = xz.shape
    D, R, N, W = D2 // 2, dt_w.shape[2], A.shape[2], conv_w.shape[2]
    if xz.dtype not in _STREAM_DTYPES:
        raise TypeError(f"mamba_fused_scan: stream dtype {xz.dtype} not in {_STREAM_DTYPES}")
    if D2 != 2 * D or conv_w.shape[:2] != (G, D) or x_proj.shape != (G, R + 2 * N, D):
        raise ValueError("mamba_fused_scan: inconsistent shapes")
    if N > 32 or N & (N - 1):
        raise ValueError(f"mamba_fused_scan: d_state {N} must be a power of two <= 32")

    sd, dev = xz.dtype, xz.device

    def f32(t, rounded=False):
        t = t.to(dev)
        return (t.to(sd) if rounded else t).float().contiguous()

    xz = xz.contiguous()
    cb = torch.zeros(G, D, device=dev) if conv_b is None else f32(conv_b)
    args = [f32(conv_w, True), cb, f32(x_proj, True), f32(dt_w, True), f32(dt_b),
            f32(A), f32(D_skip)]
    T = _chunk_len(D, R + 2 * N)
    n_chunks = -(-L // T)
    state = torch.empty(Bsz, G, n_chunks, D, N, device=dev)
    dtsum = torch.empty(Bsz, G, n_chunks, D, device=dev)
    out = torch.empty(Bsz, G, D, L, dtype=sd, device=dev)
    err = _build.library().mamba_fused_fwd(
        xz.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in args),
        state.data_ptr(), dtsum.data_ptr(), Bsz, G, D, L, N, R, W, T,
        int(reverse), int(sd == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "mamba_fused_fwd")
    mamba_fused_scan.launches += 1
    return out


mamba_fused_scan.launches = 0
