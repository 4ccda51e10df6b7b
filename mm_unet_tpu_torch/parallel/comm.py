"""Process communication helpers over `torch.distributed` (counterpart of
`mm_unet_tpu/parallel/comm.py`, the reference's `utils/comm.py`): rank and
world size, a barrier, an all-gather of picklable objects and a sum or mean
of scalar dicts. Without a process group each gives the one-process answer.

Four differentiable collectives, each with its adjoint stated (each
collective takes a contiguous copy: NCCL refuses strided tensors):
- `all_reduce_sum`: the sum over ranks forward and backward, for a value
  every rank computes from its own part and every rank's loss reads (the
  cross-rank BatchNorm statistics, the row-parallel x_proj of `tp.py`);
  this is `torch.distributed.nn.functional.all_reduce`, whose backward
  all-reduces too, so it cannot serve as g: g's total feeds replicated
  work, and summing its gradient over the ranks would count it world
  times;
- `copy_to_group` (Megatron's f): identity forward, all-reduce backward,
  for a replicated input of sharded work;
- `reduce_from_group` (Megatron's g): all-reduce forward, identity
  backward, for partial sums whose total feeds replicated work;
- `all_gather_stack`: the ranks' tensors stacked forward; backward, the
  sum over ranks of the gradient of this rank's slot (an all-reduce of the
  whole stack, which every backend takes, where `torch.distributed.nn`
  uses reduce-scatter or all-to-all).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.nn.functional import all_reduce as _nn_all_reduce


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if initialized() else 1


def get_rank(group=None) -> int:
    return dist.get_rank(group) if initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize(group=None) -> None:
    """A barrier across the group's processes (reference `comm.py:50-57`)."""
    if get_world_size(group) > 1:
        dist.barrier(group)


def all_gather(data: Any, group=None) -> list[Any]:
    """Every process's picklable `data`, in rank order (reference
    `comm.py:63-103`)."""
    if get_world_size(group) == 1:
        return [data]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, data, group=group)
    return out


def _host_device(group) -> torch.device:
    """Where a tensor must lie for a collective of the group: the card of
    this process under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_dict(d: dict[str, Any], average: bool = True, group=None) -> dict[str, float]:
    """The sum over processes of each scalar of `d` (the same keys on every
    process), or the mean with `average` (reference `comm.py:106-132`)."""
    if get_world_size(group) == 1:
        return {k: float(v) for k, v in d.items()}
    keys = sorted(d)
    vals = torch.tensor([float(d[k]) for k in keys], dtype=torch.float64,
                        device=_host_device(group))
    dist.all_reduce(vals, group=group)
    if average:
        vals /= dist.get_world_size(group)
    return {k: float(v) for k, v in zip(keys, vals.tolist())}


def all_reduce_sum(x: torch.Tensor, group: Optional[object] = None) -> torch.Tensor:
    """The differentiable sum of `x` over the group's ranks (PyTorch's own:
    its backward all-reduces the gradient)."""
    return _nn_all_reduce(x, group=group or dist.group.WORLD)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _AllGatherStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rank = group, dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dy, group=ctx.group)
        return dy[ctx.rank], None


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group=None) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def all_gather_stack(x: torch.Tensor, group=None) -> torch.Tensor:
    """(world, *x.shape): every rank's x, in rank order."""
    return _AllGatherStack.apply(x, group)
