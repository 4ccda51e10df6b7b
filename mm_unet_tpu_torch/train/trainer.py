"""The training step (counterpart of `mm_unet_tpu/train/trainer.py`).

One step: the model in train mode, the loss, the backward pass through the
hand-written backward kernels, the learning rate set from the step count,
and the AdamW update. BatchNorm's running statistics are updated in place
by the forward pass (the JAX step returns them as a new collection).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import torch
import torch.nn as nn

from mm_unet_tpu_torch.train.losses import LOSS_REGISTRY
from mm_unet_tpu_torch.train.optim import build_optimizer, set_lr, warmup_cosine_epoch_schedule


@dataclass
class TrainState:
    """model (trained in place), its AdamW optimizer, the step -> lr
    schedule, the count of steps taken, and the generator that draws the
    Dropout2d masks (on the model's device)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: torch.Generator
    step: int = 0


def create_train_state(model: nn.Module, config: Mapping, seed: int = 0) -> TrainState:
    """config["trainer"] keys, as the JAX package reads them: lr, warmup,
    num_epochs, and optionally steps_per_epoch (1), warmup_start_lr (0),
    optimizer ("adamw") and weight_decay (0.05). The config is a mapping
    (the JAX package's ConfigDict is one)."""
    tcfg = config["trainer"]
    schedule = warmup_cosine_epoch_schedule(
        base_lr=float(tcfg["lr"]),
        warmup_epochs=int(tcfg["warmup"]),
        max_epochs=int(tcfg["num_epochs"]),
        steps_per_epoch=int(tcfg.get("steps_per_epoch", 1) or 1),
        warmup_start_lr=float(tcfg.get("warmup_start_lr", 0.0) or 0.0),
    )
    optimizer = build_optimizer(model, opt=tcfg.get("optimizer", "adamw"), lr=schedule(0),
                                weight_decay=float(tcfg.get("weight_decay", 0.05)))
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    if hasattr(model, "set_dropout_generator"):
        model.set_dropout_generator(generator)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule, generator=generator)


def make_loss_fn(loss_functions: Mapping[str, Mapping], loss_weights: Mapping[str, float]):
    """loss_functions: {name: kwargs} over LOSS_REGISTRY entries. The
    returned fn(logits, labels, weight=None) gives (total, {name: loss})."""

    def compute(logits, labels, weight=None):
        losses = {}
        total = 0.0
        for name, kwargs in loss_functions.items():
            base = name if name in LOSS_REGISTRY else name.replace("_loss", "") + "_loss"
            fn = LOSS_REGISTRY.get(name, LOSS_REGISTRY.get(base))
            if fn is None:
                raise KeyError(f"loss {name!r} is not in LOSS_REGISTRY {sorted(LOSS_REGISTRY)}")
            val = fn(logits, labels, weight=weight, **kwargs)
            losses[name] = val
            total = total + loss_weights.get(name, 1.0) * val
        return total, losses

    return compute


def seg_stats(logits: torch.Tensor, labels: torch.Tensor,
              weight: Optional[torch.Tensor] = None) -> dict:
    """Sufficient statistics of the seven metrics for one batch: after
    sigmoid > 0.5, per-(sample, channel) intersection, prediction sum and
    target sum (B, C), and the pixel count per plane."""
    preds = (torch.sigmoid(logits) > 0.5).float()
    t = labels.float()
    dims = tuple(range(2, preds.ndim))
    npix = 1
    for d in dims:
        npix *= preds.shape[d]
    stats = {"inter": (preds * t).sum(dims), "psum": preds.sum(dims), "tsum": t.sum(dims),
             "npix": npix}
    if weight is not None:
        stats["weight"] = weight
    return stats


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               loss_fn: Callable, sample_weight: Optional[torch.Tensor] = None):
    """One optimizer step; `state` is updated in place. The learning rate
    is the schedule at the step count before this step (optax's
    convention: the first update uses lr(0)). Returns (scalars, stats):
    {"total_loss", per-loss values} as detached 0-d tensors, and
    `seg_stats` of the logits."""
    model = state.model
    model.train()
    set_lr(state.optimizer, state.schedule(state.step))
    state.optimizer.zero_grad(set_to_none=True)
    logits = model(images)
    total, losses = loss_fn(logits, labels, weight=sample_weight)
    total.backward()
    state.optimizer.step()
    state.step += 1
    scalars = {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}
    return scalars, seg_stats(logits.detach(), labels, sample_weight)
