"""Selective scan (Mamba S6 recurrence), plain PyTorch (counterpart of
`mm_unet_tpu/ops/selective_scan.py::selective_scan_ref`):

    delta = softplus(delta + delta_bias)          (optional)
    h_t   = exp(delta_t * A) * h_{t-1} + delta_t * B_t * u_t
    y_t   = C_t . h_t + D * u_t, gated by silu(z_t) (D, z optional)

The state and every reduction are f32; the result has u's dtype. The
recurrence walks the tokens one at a time (one fused multiply-add launch per
token), so this is the oracle for the kernels, forward and (through autograd)
backward, not a fast path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _normalize_bc(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, bool]:
    """B/C as (D, N) constant, or variable (B, N, L) / grouped (B, G, N, L)
    -> (batch, dim, N, L) f32. Returns (tensor, is_variable)."""
    x = x.float()
    if x.ndim == 2:
        return x, False
    if x.ndim == 3:
        x = x[:, None]
    g = x.shape[1]
    if g != dim:
        x = x.repeat_interleave(dim // g, dim=1)
    return x, True


def selective_scan_ref(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    return_last_state: bool = False,
):
    """u/delta (B, D, L); A (D, N); B/C (D, N) | (B, N, L) | (B, G, N, L);
    D (D,); z (B, D, L); delta_bias (D,). Returns (B, D, L) and, when asked,
    the last state (B, D, N) f32."""
    uf = u.float()
    dlt = delta.float()
    if delta_bias is not None:
        dlt = dlt + delta_bias.float()[None, :, None]
    if delta_softplus:
        dlt = F.softplus(dlt)
    batch, dim, length = uf.shape
    Af = A.float()
    bm, var_b = _normalize_bc(B, dim)
    cm, var_c = _normalize_bc(C, dim)

    # token-major (L, B, D, N) so that every step reads and writes one
    # contiguous slab with a single fused multiply-add
    decay = torch.exp(dlt.permute(2, 0, 1)[..., None] * Af).contiguous()
    b_t = bm.permute(3, 0, 1, 2) if var_b else bm[None, None]
    drive = ((dlt * uf).permute(2, 0, 1)[..., None] * b_t).contiguous()
    # states collected in a list and stacked (no out=): autograd differentiates
    # through the loop, so this version is also the gradient oracle
    h = torch.zeros_like(decay[0])
    states = []
    for t in range(length):
        h = torch.addcmul(drive[t], decay[t], h)
        states.append(h)
    hs = torch.stack(states) if length else decay
    c_t = cm.permute(3, 0, 1, 2) if var_c else cm[None, None]
    y = (hs * c_t).sum(-1).permute(1, 2, 0)  # (B, D, L)
    if D is not None:
        y = y + uf * D.float()[None, :, None]
    if z is not None:
        y = y * F.silu(z.float())
    out = y.to(u.dtype)
    if return_last_state:
        return out, h
    return out
