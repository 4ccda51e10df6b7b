"""Expert parallelism: a top-1 Switch mixture-of-experts feed-forward
whose experts are split over an `expert` group (counterpart of
`mm_unet_tpu/parallel/ep.py`). No model of the registry uses it.

`SwitchFFN`, as the JAX module: a router, top-1 routing with a fixed
capacity C = ceil(T / E · capacity_factor) per expert, dispatch and combine
as dense one-hot products, a GELU MLP per expert, the gated combine, and
the tokens past an expert's capacity left on the residual path. It returns
(y, aux) with the Switch load-balance loss aux = E · Σ_e f_e p_e (1 at
perfect balance).

Split over a group of n ranks (`shard_moe_params`), a rank keeps E / n
experts' W1 and W2 and computes only their slots: the tokens are the same
on every rank and reach the experts through Megatron's f (identity
forward, all-reduce backward), and the combine's partial sums are
all-reduced (g), so the output equals the unsplit module's. The JAX module
lets GSPMD place the same collectives.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.layers import lecun_normal_
from mm_unet_tpu_torch.parallel.comm import copy_to_group, reduce_from_group

# the expert-stacked MLP weights split their leading E axis (`ep.py:96-99`)
MOE_EP_RULES: list[tuple[str, int]] = [(r"(^|\.)W1$", 0), (r"(^|\.)W2$", 0)]


class SwitchFFN(nn.Module):
    """Top-1 token-choice MoE feed-forward over (..., L, d_model) tokens.
    Parameters as the JAX module names them: `router` (d_model -> E, no
    bias), `W1` (E, d_model, d_ff), `W2` (E, d_ff, d_model)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, capacity_factor: float = 1.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.d_model, self.d_ff, self.n_experts = d_model, d_ff, n_experts
        self.capacity_factor = capacity_factor
        self.router = nn.Linear(d_model, n_experts, bias=False)
        lecun_normal_(self.router.weight, d_model, g)
        # flax's lecun_normal on (E, fan_in, fan_out) counts E in the fan-in
        self.W1 = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.W2 = nn.Parameter(torch.empty(n_experts, d_ff, d_model))
        lecun_normal_(self.W1, n_experts * d_model, g)
        lecun_normal_(self.W2, n_experts * d_ff, g)
        self.ep = None  # the expert group (`shard_moe_params`)
        self.first_expert = 0

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        shape, E = x.shape, self.n_experts
        xt = x.reshape(-1, self.d_model).float()  # (T, d)
        T = xt.shape[0]
        C = max(1, math.ceil(T / E * self.capacity_factor))
        probs = torch.softmax(self.router(xt), dim=-1)  # (T, E)
        gate, choice = probs.max(dim=-1)
        onehot = F.one_hot(choice, E).float()
        aux = E * (onehot.mean(0) * probs.mean(0)).sum()
        pos = torch.cumsum(onehot, dim=0) - onehot  # each token's place in its expert's queue
        keep = (pos < C).float() * onehot
        rank = (pos * onehot).sum(-1)
        slot = (rank[:, None] == torch.arange(C, device=x.device)).float()  # (T, C), 0 past C
        dispatch = keep[:, :, None] * slot[:, None, :]  # (T, E, C)
        e0, el = self.first_expert, self.W1.shape[0]
        dispatch = dispatch[:, e0:e0 + el]  # this rank's experts
        xe = xt if self.ep is None else copy_to_group(xt, self.ep)
        xin = torch.einsum("tec,td->ecd", dispatch, xe)
        h = F.gelu(torch.einsum("ecd,edf->ecf", xin, self.W1), approximate="tanh")
        yt = torch.einsum("tec,ecd->td", dispatch, torch.einsum("ecf,efd->ecd", h, self.W2))
        if self.ep is not None:
            yt = reduce_from_group(yt, self.ep)
        y = (xt + yt * gate[:, None]).to(x.dtype)
        return y.reshape(shape), aux


def ep_param_specs(module: nn.Module, n_shards: int, rules=MOE_EP_RULES) -> dict:
    """{parameter name: split dimension or None} at a group of `n_shards`."""
    from mm_unet_tpu_torch.parallel.tp import spec_for

    return {k: spec_for(k, p.shape, n_shards, rules) for k, p in module.named_parameters()}


def shard_moe_params(model: nn.Module, group=None) -> nn.Module:
    """Split every SwitchFFN's experts over the group's ranks in place (the
    router and everything else stay whole). E must be a multiple of the
    group's size."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    for prefix, m in model.named_modules():
        if not isinstance(m, SwitchFFN):
            continue
        if m.n_experts % world:
            raise ValueError(f"{prefix}: {m.n_experts} experts over {world} ranks")
        per = m.n_experts // world
        for name in ("W1", "W2"):  # MOE_EP_RULES
            w = getattr(m, name).detach()
            setattr(m, name, nn.Parameter(w[rank * per:(rank + 1) * per].clone()))
        m.ep, m.first_expert = group or dist.group.WORLD, rank * per
    return model
