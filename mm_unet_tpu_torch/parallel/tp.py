"""Tensor parallelism of the Mamba mixer over its channel axis, Megatron's
pattern (counterpart of `mm_unet_tpu/parallel/tp.py`).

Every (channel, state) of the scan evolves on its own; only B, C and dt's
low-rank input are shared. So a rank of the `model` group keeps a block of
d_inner / n channels of every channel-indexed parameter:

- in_proj (column-parallel): the rows of its x half and of its z half that
  belong to the rank's channels; xz comes out channel-sharded;
- conv1d, dt_proj's bias, A_log, D: their channel rows;
- x_proj (row-parallel): its channel columns; x_dbl = x_proj · x is a
  partial sum, all-reduced (forward and backward: every rank's channels
  read the whole x_dbl, so its gradient is the sum of theirs);
- dt_proj's weight (column-parallel): its channel rows, so dt is sharded;
- out_proj (row-parallel): its channel columns; the output is a partial
  sum, all-reduced (Megatron's g: the rest of the model is replicated);
- the mixer's input passes through Megatron's f (identity forward,
  all-reduce backward), since every rank's in_proj rows read all of it.

The JAX package states this as parameter shardings and lets GSPMD insert
the collectives; here they are written out (`parallel/comm.py`) in
`Mamba.forward` and `_fused_scan`, run when the module's `tp` is set. The
rules are `mm_unet_tpu/parallel/tp.py`'s MAMBA_TP_RULES read on the
torch names (a sharded dimension per name). A Mamba whose d_inner the
group's size does not divide stays replicated, as `spec_for` falls back
(every rule shards the d_inner axis, so all of them fall back together).

The fused Mamba kernel (kernel 1) contracts x_proj inside the kernel, so
a tensor-parallel Mamba takes the grouped-scan route (`scan_impl`
"pallas": kernels 5/6 on the card); `shard_params` refuses the megakernel
route. The direction outputs a v3 Mamba returns beside `out` hold the
rank's channels only.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

# (regex over the torch parameter name, the dimension split over the group)
MAMBA_TP_RULES: list[tuple[str, int]] = [
    (r"in_proj\.weight$", 0),
    (r"x_proj(_[bs])?\.weight$", 1),
    (r"dt_proj(_[bs])?\.weight$", 0),
    (r"dt_proj(_[bs])?\.bias$", 0),
    (r"conv1d(_[bs])?\.weight$", 0),
    (r"conv1d(_[bs])?\.bias$", 0),
    (r"A(_[bs])?_log$", 0),
    (r"(^|\.)D(_[bs])?$", 0),
    (r"out_proj\.weight$", 1),
    (r"in_proj\.bias$", 0),
]
# in_proj stacks the x and z halves: a rank takes its channels of each
_HALVES = re.compile(r"in_proj\.(weight|bias)$")


def spec_for(name: str, shape: Sequence[int], n_shards: int,
             rules=MAMBA_TP_RULES) -> Optional[int]:
    """The dimension the first matching rule splits, or None (replicated):
    no rule matches, or the size does not divide that dimension."""
    for pat, dim in rules:
        if re.search(pat, name):
            if dim >= len(shape) or shape[dim] % n_shards:
                return None
            return dim
    return None


def tp_param_specs(model: nn.Module, n_shards: int, rules=MAMBA_TP_RULES) -> dict:
    """{parameter name: split dimension or None} that `shard_params` would
    apply at a group of `n_shards`."""
    return {k: spec_for(k, p.shape, n_shards, rules) for k, p in model.named_parameters()}


def local_slice(t: torch.Tensor, name: str, dim: int, rank: int, world: int) -> torch.Tensor:
    """This rank's block of a whole parameter (in_proj: its block of each
    of the x and z halves)."""
    if _HALVES.search(name):
        x, z = t.chunk(2, dim=dim)
        return torch.cat([local_slice(x, "", dim, rank, world),
                          local_slice(z, "", dim, rank, world)], dim=dim)
    return t.chunk(world, dim=dim)[rank]


def shard_params(model: nn.Module, group=None, rules=MAMBA_TP_RULES) -> nn.Module:
    """Split every Mamba of `model` over the group's ranks in place: its
    channel-indexed parameters replaced by this rank's blocks, its `tp`
    set. Other parameters stay whole (replicated)."""
    from mm_unet_tpu_torch.models.mamba import Mamba

    rank, world = dist.get_rank(group), dist.get_world_size(group)
    for prefix, m in model.named_modules():
        if not isinstance(m, Mamba) or m.d_inner % world:
            continue
        if m.use_mega:
            raise ValueError(f"{prefix}: a tensor-parallel Mamba takes the grouped-scan route "
                             "(scan_impl='pallas'); the fused kernel contracts x_proj itself")
        for name, p in list(m.named_parameters()):
            dim = spec_for(name, p.shape, world, rules)
            if dim is None:
                continue
            owner = m.get_submodule(name.rpartition(".")[0]) if "." in name else m
            local = local_slice(p.detach(), name, dim, rank, world).clone()
            setattr(owner, name.rpartition(".")[2], nn.Parameter(local))
        m.d_inner //= world
        m.tp = group or dist.group.WORLD
    return model
