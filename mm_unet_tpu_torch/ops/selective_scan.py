"""Selective scan (Mamba S6 recurrence): the entry point `selective_scan`
and its plain PyTorch version (counterpart of
`mm_unet_tpu/ops/selective_scan.py`):

    delta = softplus(delta + delta_bias)          (optional)
    h_t   = exp(delta_t * A) * h_{t-1} + delta_t * B_t * u_t
    y_t   = C_t . h_t + D * u_t, gated by silu(z_t) (D, z optional)

The state and every reduction are f32; the result has u's dtype. The plain
recurrence `selective_scan_ref` walks the tokens one at a time (one fused
multiply-add launch per token), so it is the oracle for the kernels, forward
and (through autograd) backward, not a fast path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# two behaviours: "auto" (the chunked scan kernels on CUDA tensors) and "ref"
# (the plain recurrence). The JAX dispatcher's other names are kept so that
# a configuration carries across: "pallas" is "auto", and "assoc" is "ref"
# (the JAX package's associative scan computes the same recurrence)
_ALIASES = {"pallas": "auto", "assoc": "ref"}
IMPLEMENTATIONS = ("auto", "ref", *_ALIASES)


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


def _prep_delta(delta: torch.Tensor, delta_bias: Optional[torch.Tensor],
                delta_softplus: bool) -> torch.Tensor:
    """dt in f32: delta (+ bias), through softplus when asked."""
    dlt = delta.float()
    if delta_bias is not None:
        dlt = dlt + delta_bias.float()[None, :, None]
    if delta_softplus:
        dlt = F.softplus(dlt)
    return dlt


def _finalize(y: torch.Tensor, u: torch.Tensor, D: Optional[torch.Tensor],
              z: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """y (+ D u), gated by silu(z), cast to `dtype`."""
    if D is not None:
        y = y + u.float() * D.float()[None, :, None]
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(dtype)


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
    dlt = _prep_delta(delta, delta_bias, delta_softplus)
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
    # through the loop, so this version is also the gradient oracle. The
    # per-token slices come from one unbind, whose backward stacks the
    # tokens' gradients once (indexing would write a whole-tensor gradient
    # per token: quadratic in L)
    h = torch.zeros_like(decay[0])
    states = []
    for drive_t, decay_t in zip(drive.unbind(0), decay.unbind(0)):
        h = torch.addcmul(drive_t, decay_t, h)
        states.append(h)
    hs = torch.stack(states) if length else decay
    c_t = cm.permute(3, 0, 1, 2) if var_c else cm[None, None]
    y = (hs * c_t).sum(-1).permute(1, 2, 0)  # (B, D, L)
    out = _finalize(y, uf, D, z, u.dtype)
    if return_last_state:
        return out, h
    return out


def selective_scan(
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
    implementation: Optional[str] = None,
):
    """The reference's `selective_scan_fn`: same inputs and outputs as
    `selective_scan_ref`, differentiable in every tensor argument; with
    `return_last_state`, (out, last state) where the last state takes no
    gradient.

    `implementation`: None or "auto" (alias "pallas") launches the chunked
    scan kernels (`ops/chunked_scan.py`) on CUDA tensors and takes the plain
    version on CPU tensors; "ref" (alias "assoc") asks for the plain
    recurrence on any device."""
    impl = implementation or "auto"
    if impl not in IMPLEMENTATIONS:
        raise ValueError(f"selective_scan: implementation {impl!r} not in {IMPLEMENTATIONS}")
    if _ALIASES.get(impl, impl) == "auto" and u.device.type != "cpu":
        from mm_unet_tpu_torch.ops.chunked_scan import selective_scan_chunked

        return selective_scan_chunked(u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                                      return_last_state)
    res = selective_scan_ref(u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                             return_last_state)
    if return_last_state:
        return res[0], res[1].detach()
    return res
