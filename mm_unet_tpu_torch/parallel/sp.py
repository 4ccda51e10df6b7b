"""Sequence parallelism: the selective scan with its token axis split over
ranks (counterpart of `mm_unet_tpu/parallel/sp.py`).

The recurrence h_t = a_t h_{t-1} + b_t splits over ranks as the scan kernel
splits it over chunks:

1. each rank scans its tokens from a zero state: y_loc, its last state
   h_end, and its total decay a_tot = exp(A · Σ dt);
2. one all-gather of the (B, D, N) pairs (h_end, a_tot), then the exclusive
   prefix over the ranks before this one, h_in_i = a_tot_{i-1} h_in_{i-1}
   + h_end_{i-1};
3. the correction y_t += C_t · (h_in · exp(A · cumsum(dt)_t)), the incoming
   state decayed to every local token.

Gradients flow through the exchange: the local scan's last state is
differentiable (on the card, kernel 8 seeds its adjoint carry with the
last state's gradient), and the all-gather's adjoint sums each rank's
slot over the ranks (`comm.all_gather_stack`). The replicated inputs A,
D and delta_bias pass through Megatron's f (`comm.copy_to_group`), so
their gradients come out summed over the ranks, as the JAX shard_map's
transpose sums them. At world size 1 the local result is returned as it
is (`sp.py:69-71`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from mm_unet_tpu_torch.ops.selective_scan import _finalize, _prep_delta, selective_scan_ref
from mm_unet_tpu_torch.parallel.comm import all_gather_stack, copy_to_group


def local_scan(u, delta, A, B, C):
    """The bare scan of one shard from a zero state, f32: (y, last state),
    both differentiable. Kernels 7/8 on CUDA tensors; on CPU tensors the
    plain recurrence (`selective_scan_ref`, its last state not detached)."""
    if u.device.type == "cuda":
        from mm_unet_tpu_torch.ops.chunked_scan import selective_scan_chunked_last

        return selective_scan_chunked_last(u, delta, A, B, C)
    return selective_scan_ref(u, delta, A, B, C, return_last_state=True)


def _shard_body(u, delta, A, B4, C4, group, world: int):
    """u/delta (B, D, Lloc) f32, delta prepped; A (D, N); B4/C4 (B, G, N,
    Lloc). Returns y (B, D, Lloc) f32 before the D-skip and gate."""
    y_loc, h_end = local_scan(u, delta, A, B4, C4)
    if world == 1:
        return y_loc
    s = torch.cumsum(delta, dim=-1)  # (B, D, Lloc), inclusive
    a_tot = torch.exp(s[..., -1:] * A[None])  # (B, D, N)
    h_all = all_gather_stack(h_end, group)  # (world, B, D, N)
    a_all = all_gather_stack(a_tot, group)
    # the prefix for every rank, as `sp.py:78-84`: every rank's backward then
    # reaches the all-gathers, whose adjoints are collectives
    h_in = [torch.zeros_like(h_end)]
    for i in range(1, world):
        h_in.append(a_all[i - 1] * h_in[i - 1] + h_all[i - 1])
    h_in = torch.stack(h_in)[dist.get_rank(group)]
    decay = torch.exp(s[..., None] * A[None, :, None, :])  # (B, D, Lloc, N)
    ct = C4.repeat_interleave(u.shape[1] // C4.shape[1], dim=1).transpose(2, 3)  # (B, D, Lloc, N)
    return y_loc + (ct * h_in[:, :, None, :] * decay).sum(-1)


def selective_scan_sp(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    *,
    group=None,
) -> torch.Tensor:
    """The selective scan of a sequence whose tokens are split over the
    group's ranks in rank order: u, delta, z (B, D, Lloc), B/C (B, N, Lloc)
    or (B, G, N, Lloc) are this rank's tokens; A (D, N), D, delta_bias (D,)
    are whole. Returns this rank's (B, D, Lloc), numerically the
    single-device scan's tokens, differentiable in every tensor input.
    A constant (D, N) B/C is not taken (as `sp.py:55-57`)."""
    if B.ndim == 2 or C.ndim == 2:
        raise ValueError("sequence-parallel scan needs variable (B,[G,]N,L) B/C")
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if world > 1:
        A, D, delta_bias = (None if t is None else copy_to_group(t, group)
                            for t in (A, D, delta_bias))
    uf = u.float()
    deltaf = _prep_delta(delta, delta_bias, delta_softplus)
    B4 = (B if B.ndim == 4 else B[:, None]).float()
    C4 = (C if C.ndim == 4 else C[:, None]).float()
    y = _shard_body(uf, deltaf, A.float(), B4, C4, group, world)
    return _finalize(y, uf, D, z, u.dtype)
