"""ZeRO-1: the AdamW moments split over the data-parallel ranks
(counterpart of `mm_unet_tpu/parallel/zero.py`).

The JAX package lays its flat AdamW vectors out over the `data` mesh axis,
so that each device keeps and updates 1/n of the moments and GSPMD
all-gathers the update. The port's optimizer is a per-parameter
`torch.optim.AdamW` (the flat layout is TPU scaffolding it left out), so
here each rank owns a share of the parameters, chosen greedily by size:
it keeps the moments of its share only, steps them with the same AdamW
(gradients already summed over the ranks), and every parameter is then
broadcast from its owner, one flat buffer per rank.

A checkpoint holds the whole optimizer state, gathered from the owners in
the layout a plain `torch.optim.AdamW` over the same parameter groups has,
so it loads at any world size, into this optimizer or a plain AdamW
(the JAX package's "topology-independent checkpoint layout").
`torch.distributed.optim.ZeroRedundancyOptimizer` is not used: it
consolidates its state onto one rank in its own layout, which a plain
AdamW does not load.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def partition(sizes: list[int], world: int) -> list[int]:
    """The owner rank of each parameter: the largest first, each to the
    rank with the fewest elements so far (ties to the lower rank)."""
    load = [0] * world
    owner = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        r = min(range(world), key=lambda r: (load[r], r))
        owner[i] = r
        load[r] += sizes[i]
    return owner


class ZeroAdamW:
    """AdamW over `param_groups` (`train.optim.param_groups`) with the
    moments of this rank's share only. `param_groups` are the local
    optimizer's (the trainer sets their lr); `state_dict` and
    `load_state_dict` are collective over the run's host group."""

    def __init__(self, param_groups: list[dict], dp, **adamw):
        self.dp = dp
        self.params = [p for g in param_groups for p in g["params"]]
        self.group_sizes = [len(g["params"]) for g in param_groups]
        self.owner = partition([p.numel() for p in self.params], dp.world)
        mine = {id(p) for p, r in zip(self.params, self.owner) if r == dp.rank}
        self.optim = torch.optim.AdamW(
            [{**g, "params": [p for p in g["params"] if id(p) in mine]} for g in param_groups],
            **adamw)

    @property
    def param_groups(self):
        return self.optim.param_groups

    def register_step_post_hook(self, hook):
        return self.optim.register_step_post_hook(hook)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.optim.step()
        src_of = (dist.get_global_rank(self.dp.group, r) if self.dp.group is not None else r
                  for r in range(self.dp.world))
        for r, src in enumerate(src_of):
            owned = [p for p, o in zip(self.params, self.owner) if o == r]
            if not owned:
                continue
            flat = _flatten_dense_tensors(owned)
            dist.broadcast(flat, src, group=self.dp.group)
            for p, v in zip(owned, _unflatten_dense_tensors(flat, owned)):
                p.copy_(v)

    def state_dict(self) -> dict:
        """The whole state on every rank, as a plain AdamW over the same
        groups would give it (tensors on the CPU)."""
        index = {id(p): i for i, p in enumerate(self.params)}
        mine = {index[id(p)]: {k: v.detach().cpu() if torch.is_tensor(v) else v
                               for k, v in self.optim.state[p].items()}
                for g in self.optim.param_groups for p in g["params"] if p in self.optim.state}
        parts = [None] * self.dp.world
        dist.all_gather_object(parts, mine, group=self.dp.host)
        state = {i: s for part in parts for i, s in part.items()}
        groups, start = [], 0
        for g, n in zip(self.optim.param_groups, self.group_sizes):
            groups.append({**{k: v for k, v in g.items() if k != "params"},
                           "params": list(range(start, start + n))})
            start += n
        return {"state": dict(sorted(state.items())), "param_groups": groups}

    def load_state_dict(self, sd: dict) -> None:
        """This rank's share of a whole state (`state_dict`'s layout)."""
        index = {id(p): i for i, p in enumerate(self.params)}
        groups = []
        state = {}
        local = 0
        for g, saved in zip(self.optim.param_groups, sd["param_groups"]):
            ids = []
            for p in g["params"]:
                i = index[id(p)]
                if i in sd["state"]:
                    state[local] = sd["state"][i]
                ids.append(local)
                local += 1
            groups.append({**{k: v for k, v in saved.items() if k != "params"}, "params": ids})
        self.optim.load_state_dict({"state": state, "param_groups": groups})
