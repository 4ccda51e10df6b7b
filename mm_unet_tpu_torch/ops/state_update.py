"""Single-token selective-state update for autoregressive decoding, plain
PyTorch (counterpart of `mm_unet_tpu/ops/state_update.py::
selective_state_update`, which is plain JAX):

    dt     = softplus(dt + dt_bias)                (both optional)
    state' = state * exp(dt * A) + dt * B * x
    y      = C . state' + D * x, gated by silu(z)  (D, z optional)

The state and every sum are f32; y has x's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def selective_state_update(
    state: torch.Tensor,                    # (B, D, N) f32
    x: torch.Tensor,                        # (B, D)
    dt: torch.Tensor,                       # (B, D)
    A: torch.Tensor,                        # (D, N)
    B: torch.Tensor,                        # (B, N)
    C: torch.Tensor,                        # (B, N)
    D: Optional[torch.Tensor] = None,       # (D,)
    z: Optional[torch.Tensor] = None,       # (B, D)
    dt_bias: Optional[torch.Tensor] = None,  # (D,)
    dt_softplus: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, D), new_state (B, D, N) f32)."""
    dtf = dt.float()
    if dt_bias is not None:
        dtf = dtf + dt_bias.float()[None]
    if dt_softplus:
        dtf = F.softplus(dtf)
    xf = x.float()
    decay = torch.exp(dtf[..., None] * A.float()[None])
    drive = dtf[..., None] * B.float()[:, None, :] * xf[..., None]
    new_state = state.float() * decay + drive
    y = torch.einsum("bdn,bn->bd", new_state, C.float())
    if D is not None:
        y = y + D.float()[None] * xf
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(x.dtype), new_state
