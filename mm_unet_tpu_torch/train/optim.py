"""AdamW and the learning-rate schedule (counterpart of
`mm_unet_tpu/train/optim.py`).

The reference's setup: timm's AdamW (lr 1e-3, betas (0.9, 0.95), weight
decay 0.05) with no decay on biases, norm scales and the Mamba no-decay
set, and the closed-form linear-warmup cosine schedule stepped per epoch.
`torch.optim.AdamW` applies the same update as `optax.adamw`:
p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), with the old p in the
decay term. The JAX package's flat/hybrid AdamW layout is TPU scaffolding
and has no counterpart here.

One difference from the JAX package is deliberate: it stores each dt_proj
weight shifted, as w + dt_rank**-0.5 (`models/mamba.py:119-120`), and
decays the stored value, which pulls w towards -dt_rank**-0.5. The port
decays w towards 0, as the torch reference's AdamW does (ROADMAP.md,
queue 3).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch
import torch.nn as nn

# parameter names that never get weight decay (the JAX package's
# _NO_DECAY_NAMES: the Mamba A/D parameters and MMConv's altho)
_NO_DECAY_NAMES = ("A_log", "A_b_log", "A_s_log", "D", "D_b", "D_s", "altho")


def wd_mask(named_params: Iterable[tuple[str, torch.Tensor]]) -> dict[str, bool]:
    """{parameter name: True where weight decay applies}, by the JAX
    package's rule read on torch names: no decay for the no-decay names,
    names ending in "bias", and tensors of at most one dimension."""
    mask = {}
    for name, p in named_params:
        leaf = name.rsplit(".", 1)[-1]
        mask[name] = not (leaf in _NO_DECAY_NAMES or leaf.endswith("bias") or p.ndim <= 1)
    return mask


def param_groups(model: nn.Module, weight_decay: float) -> list[dict]:
    """Two AdamW parameter groups: decayed and not decayed (`wd_mask`)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    mask = wd_mask(named)
    return [
        {"params": [p for n, p in named if mask[n]], "weight_decay": weight_decay},
        {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
    ]


def warmup_cosine_epoch_schedule(
    base_lr: float,
    warmup_epochs: int,
    max_epochs: int,
    steps_per_epoch: int,
    warmup_start_lr: float = 0.0,
    eta_min: float = 0.0,
) -> Callable[[int], float]:
    """step -> lr: the closed-form LinearWarmupCosineAnnealing schedule
    evaluated at epoch granularity (epoch = step // steps_per_epoch)."""

    def schedule(step: int) -> float:
        epoch = float(step // steps_per_epoch)
        if epoch < warmup_epochs:
            if warmup_epochs > 1:
                return warmup_start_lr + epoch * (base_lr - warmup_start_lr) / (warmup_epochs - 1)
            return base_lr
        return eta_min + 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * (epoch - warmup_epochs) / max(max_epochs - warmup_epochs, 1)))

    return schedule


def build_optimizer(model: nn.Module, opt: str = "adamw", lr: float = 1e-3,
                    weight_decay: float = 0.05,
                    betas: tuple[float, float] = (0.9, 0.95),
                    eps: float = 1e-8, zero=None):
    """AdamW over `param_groups`; the fused CUDA implementation when the
    parameters lie on the card. With `zero` (a `parallel.mesh.DataParallel`)
    the same AdamW sharded ZeRO-1 over its ranks (`parallel/zero.py`). The
    learning rate is set before each step by the trainer (`set_lr`)."""
    if opt.lower() != "adamw":
        raise NotImplementedError(f"optimizer {opt!r}")
    kwargs = dict(lr=lr, betas=betas, eps=eps, fused=next(model.parameters()).is_cuda)
    if zero is not None:
        from mm_unet_tpu_torch.parallel.zero import ZeroAdamW

        return ZeroAdamW(param_groups(model, weight_decay), zero, **kwargs)
    return torch.optim.AdamW(param_groups(model, weight_decay), **kwargs)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
