"""Data parallelism over `torch.distributed` (counterpart of
`mm_unet_tpu/parallel/mesh.py`).

The JAX package jits one SPMD step over a `data` mesh: the global batch is
sharded over the devices, wrap-padded to a multiple of their count, and
GSPMD makes the step the one-device step on the padded batch. The port
runs one process per card (torchrun) and keeps that step's arithmetic:

- every rank reads the same global batch (the same loader and seed) and
  keeps its own rows (`shard_batch`), with a weight of 1 for real rows and
  0 for pads;
- BatchNorm normalises with the statistics of the whole padded batch: the
  per-channel sum, sum of squares and count are all-reduced, differentiably
  (`DataParallel.batch_moments`; `torch.nn.SyncBatchNorm` takes no CPU
  tensors), so the running statistics update as the one-device step's do;
- dropout masks are drawn for the whole batch and each rank keeps its rows
  (`DataParallel.local_rows`), so they do not depend on the world size;
- the loss is the weighted mean over the global batch: each rank scales
  its local weighted mean by its weight sum over the global one, and the
  gradients are then summed over the ranks (one all-reduce of a flat
  buffer, `DataParallel.all_reduce_grads`; not `DistributedDataParallel`,
  which averages).

The step's scalars are summed and its metric statistics gathered on the
host over a gloo group, so the epoch's metrics are the one-rank run's.
"""

from __future__ import annotations

import os
from typing import Iterable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from mm_unet_tpu_torch.parallel.comm import all_reduce_sum


def shard_batch(batch: Mapping, rank: int, world: int):
    """This rank's rows of a global batch ({name: array or tensor}, leading
    batch axis), as `mm_unet_tpu/parallel/mesh.py:40-78` shards it: a batch
    of B rows is wrap-padded with real rows to a multiple of `world`, and
    rank r keeps rows r·b to (r + 1)·b of the padded batch. A leaf whose
    leading axis is not B is kept whole. Returns (rows, weight): the weight
    (b,) f32 is 1 for real rows and 0 for pads."""
    leaves = [v for v in batch.values() if getattr(v, "ndim", 0) > 0]
    bsz = leaves[0].shape[0] if leaves else 0
    padded = bsz + (-bsz) % world
    per = padded // world
    idx = np.arange(rank * per, (rank + 1) * per)

    def take(x):
        if getattr(x, "ndim", 0) == 0 or x.shape[0] != bsz:
            return x
        rows = idx % bsz
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(rows, device=x.device)]
        return np.take(np.asarray(x), rows, axis=0)

    weight = (idx < bsz).astype(np.float32)
    return {k: take(v) for k, v in batch.items()}, weight


class DataParallel:
    """This process's place in a data-parallel run over `group` (None: the
    default group): its rank, the world size, and a gloo group for the
    host's exchanges (the stop flag, a step's scalars and metric
    statistics), which is the group itself under gloo. `attach` hands it to
    the model's BatchNorm and dropout layers."""

    def __init__(self, group=None, owns_group: bool = False):
        self.group = group
        self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
        if dist.get_backend(group) == "gloo":
            self.host = group
        else:
            self.host = dist.new_group(dist.get_process_group_ranks(group or dist.group.WORLD),
                                       backend="gloo")
        self.owns_group = owns_group

    def __deepcopy__(self, memo):
        return self  # a handle on the process's groups: a copied model shares it

    def close(self) -> None:
        """Destroy the process group if `init_data_parallel` started it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False

    # --- the batch -------------------------------------------------------

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor drawn for the global batch."""
        per = t.shape[0] // self.world
        return t[self.rank * per:(self.rank + 1) * per]

    def batch_moments(self, xf: torch.Tensor, dims: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """BatchNorm's (mean, biased variance) over `dims` of the global
        batch: one differentiable all-reduce of the local sums and count,
        the variance E[x²] - E[x]² clipped at 0 (flax's fast variance)."""
        count = torch.full((1,), float(xf.numel() // xf.shape[1]), dtype=xf.dtype,
                           device=xf.device)
        sums = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]), self.group)
        c = xf.shape[1]
        mean = sums[:c] / sums[-1]
        return mean, torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)

    def attach(self, model: nn.Module) -> nn.Module:
        """Give every layer with a `sync` attribute (BatchNorm2d, the
        dropouts) this run."""
        for m in model.modules():
            if hasattr(m, "sync"):
                m.sync = self
        return model

    # --- the step --------------------------------------------------------

    def replicate(self, module: nn.Module) -> nn.Module:
        """Rank 0's parameters and buffers on every rank."""
        src = dist.get_global_rank(self.group, 0) if self.group is not None else 0
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, src, group=self.group)
        return module

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of `t`, in place (not differentiable)."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        """Sum every gradient over the ranks: one all-reduce per dtype of a
        flat buffer of the gradients."""
        by_dtype: dict = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = self.all_reduce(_flatten_dense_tensors(grads))
            for g, s in zip(grads, _unflatten_dense_tensors(flat, grads)):
                g.copy_(s)

    # --- the host --------------------------------------------------------

    def any(self, flag: bool) -> bool:
        """True on every rank when `flag` is true on any."""
        t = torch.tensor([int(bool(flag))])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host)
        return bool(t.item())

    def host_sum(self, values: Mapping) -> dict:
        """{name: the sum over ranks} of host scalars or arrays."""
        keys = sorted(values)
        flat = torch.cat([torch.as_tensor(np.asarray(values[k], np.float64)).reshape(-1)
                          for k in keys])
        dist.all_reduce(flat, group=self.host)
        out, i = {}, 0
        for k in keys:
            shape = np.shape(values[k])
            n = int(np.prod(shape))
            out[k] = flat[i:i + n].numpy().reshape(shape)
            i += n
        return out

    def host_gather(self, a) -> np.ndarray:
        """The ranks' host arrays (one shape on every rank) concatenated
        along the leading axis, in rank order."""
        t = torch.as_tensor(np.ascontiguousarray(a))
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.host)
        return torch.cat(parts).numpy()

    def broadcast_object(self, obj, src: int = 0):
        """Rank `src`'s picklable `obj` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.host)
        return box[0]


def init_data_parallel(device: str | torch.device = "cuda"
                       ) -> tuple[Optional[DataParallel], torch.device]:
    """Join the run torchrun started: with RANK, WORLD_SIZE and LOCAL_RANK
    (and MASTER_ADDR / MASTER_PORT) in the environment, start the process
    group (NCCL on the card, gloo on the CPU) and return (DataParallel,
    this rank's device: `cuda:LOCAL_RANK` on the card). Without them
    (a plain `python -m ...`) return (None, device): a one-process run. A
    card is never given up for the CPU: without one, asking for it raises."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return None, device
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device here; data parallelism on the CPU needs "
                               "--device cpu")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    owns = not dist.is_initialized()
    if owns:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return DataParallel(owns_group=owns), device
