"""The training step (counterpart of `mm_unet_tpu/train/trainer.py`).

One step: the model in train mode, the loss, the backward pass through the
hand-written backward kernels, the learning rate set from the step count,
and the AdamW update. BatchNorm's running statistics are updated in place
by the forward pass (the JAX step returns them as a new collection).

Under data parallelism (`TrainState.dp`, `parallel/mesh.py`) the step is the
JAX package's SPMD step on a `data` mesh: each rank's weighted loss is
scaled to its share of the global batch's weighted mean, and the gradients
are summed over the ranks before the update (ZeRO-1: `parallel/zero.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import torch
import torch.nn as nn

from mm_unet_tpu_torch.parallel.mesh import DataParallel
from mm_unet_tpu_torch.parallel.zero import ZeroAdamW
from mm_unet_tpu_torch.train.losses import LOSS_REGISTRY
from mm_unet_tpu_torch.train.optim import build_optimizer, set_lr, warmup_cosine_epoch_schedule
from mm_unet_tpu_torch.utils.torch_convert import warm_start


@dataclass
class TrainState:
    """model (trained in place), its AdamW optimizer, the step -> lr
    schedule, the count of steps taken, the generator that draws the
    Dropout2d masks (on the model's device), and the data-parallel run the
    step belongs to (None: one process)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer | ZeroAdamW
    schedule: Callable[[int], float]
    generator: torch.Generator
    step: int = 0
    dp: Optional[DataParallel] = None


def create_train_state(model: nn.Module, config: Mapping, seed: int = 0,
                       dp: Optional[DataParallel] = None) -> TrainState:
    """config["trainer"] keys, as the JAX package reads them: lr, warmup,
    num_epochs, and optionally steps_per_epoch (1), warmup_start_lr (0),
    optimizer ("adamw"), weight_decay (0.05) and, with `dp`, zero1 (true
    when the world size is above 1, as `train.py:163-169`). The config is a
    mapping (the JAX package's ConfigDict is one). First, where the selected
    model's config section names a reference `.pth` as `model_dir`, its
    backbone is loaded from it (`utils/torch_convert.py::warm_start`, as the
    JAX package's `create_train_state` does before its optimizer; a
    checkpoint resumed later overrides it). With `dp` the model is then
    replicated from rank 0 and its BatchNorm and dropout layers attached to
    the run."""
    warm_start(model, config)
    tcfg = config["trainer"]
    schedule = warmup_cosine_epoch_schedule(
        base_lr=float(tcfg["lr"]),
        warmup_epochs=int(tcfg["warmup"]),
        max_epochs=int(tcfg["num_epochs"]),
        steps_per_epoch=int(tcfg.get("steps_per_epoch", 1) or 1),
        warmup_start_lr=float(tcfg.get("warmup_start_lr", 0.0) or 0.0),
    )
    if dp is not None:
        dp.attach(dp.replicate(model))
    zero1 = dp is not None and tcfg.get("zero1", dp.world > 1)
    optimizer = build_optimizer(model, opt=tcfg.get("optimizer", "adamw"), lr=schedule(0),
                                weight_decay=float(tcfg.get("weight_decay", 0.05)),
                                zero=dp if zero1 else None)
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    if hasattr(model, "set_dropout_generator"):
        model.set_dropout_generator(generator)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule, generator=generator,
                      dp=dp)


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
    `seg_stats` of the logits.

    Under data parallelism `images` are this rank's rows, `sample_weight`
    their weights (`parallel.mesh.shard_batch`), and the scalars
    this rank's share of the global batch's losses (their sum over the
    ranks is the global loss). Each loss is scaled by max(w, 1) / max(W, 1),
    w this rank's weight sum and W the global one: a loss that is a
    weighted mean over the samples (`losses._wmean`) then becomes the
    global batch's weighted sum over W. The batch-wide Dice of `dice_bce`
    is not such a mean and is taken per rank."""
    model, dp = state.model, state.dp
    model.train()
    set_lr(state.optimizer, state.schedule(state.step))
    state.optimizer.zero_grad(set_to_none=True)
    logits = model(images)
    total, losses = loss_fn(logits, labels, weight=sample_weight)
    if dp is not None:
        w = sample_weight.detach().sum().to(torch.float32).reshape(1)
        scale = torch.clamp(w, min=1.0) / torch.clamp(dp.all_reduce(w.clone()), min=1.0)
        total, losses = total * scale[0], {k: v * scale[0] for k, v in losses.items()}
    total.backward()
    if dp is not None:
        dp.all_reduce_grads(model.parameters())
    state.optimizer.step()
    state.step += 1
    scalars = {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}
    return scalars, seg_stats(logits.detach(), labels, sample_weight)
