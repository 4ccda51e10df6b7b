"""Checkpoints and resume (counterpart of `mm_unet_tpu/train/checkpoint.py`).

The same layout as the JAX package: `model_store/<name>/best` when the
selection metric improves and `model_store/<name>/checkpoint` after every
epoch, each beside `<tag>_meta.json` holding {epoch, best_acc, best_class}.
A checkpoint file is one `torch.save` of the train state: the model's
`state_dict` (parameters and BatchNorm statistics), the optimizer's
`state_dict`, the step count and the dropout generator's state. Files are
written under a temporary name and renamed into place, so a run stopped
mid-save leaves the previous checkpoint whole.

The JAX package's `adapt_flat_opt_vectors` belongs to its flat AdamW layout,
which the port does not have; `remap_params` (flax's auto-numbered module
names) is not ported (ROADMAP.md).
"""

from __future__ import annotations

import json
import os

import torch
import torch.nn as nn

from mm_unet_tpu_torch.train.trainer import TrainState


class CheckpointManager:
    """`write` False (the ranks but 0 of a data-parallel run) builds each
    payload, which gathers a ZeRO-1 optimizer's state from every rank, and
    writes nothing."""

    def __init__(self, root: str, name: str, write: bool = True):
        self.base = os.path.abspath(os.path.join(root, name))
        self.write = write
        if write:
            os.makedirs(self.base, exist_ok=True)

    def path(self, tag: str) -> str:
        return os.path.join(self.base, tag)

    def meta_path(self, tag: str) -> str:
        return os.path.join(self.base, f"{tag}_meta.json")

    def _save(self, tag: str, state: TrainState, meta: dict):
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "generator": state.generator.get_state(),
        }
        if not self.write:
            return
        tmp = self.path(tag) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(tag))
        with open(self.meta_path(tag) + ".tmp", "w") as f:
            json.dump(meta, f)
        os.replace(self.meta_path(tag) + ".tmp", self.meta_path(tag))

    def save_best(self, state: TrainState, meta: dict):
        self._save("best", state, meta)

    def save_checkpoint(self, state: TrainState, meta: dict):
        self._save("checkpoint", state, meta)

    def read(self, tag: str) -> dict:
        """The saved payload, tensors on the CPU."""
        return torch.load(self.path(tag), map_location="cpu", weights_only=True)

    def load(self, tag: str, state: TrainState, model_only: bool = False) -> dict:
        """Restore `state` in place from `tag` and return its metadata. The
        model's tensors go to the model's device; with `model_only` the
        optimizer, step and generator stay as they are. Keys and shapes are
        checked before anything is copied, so a mismatched file leaves the
        state untouched."""
        device = next(state.model.parameters()).device
        payload = torch.load(self.path(tag), map_location=device, weights_only=True)
        have = state.model.state_dict()
        got = payload["model"]
        if set(got) != set(have) or any(got[k].shape != have[k].shape for k in have):
            bad = sorted(set(got) ^ set(have)) or [k for k in have if got[k].shape != have[k].shape]
            raise ValueError(f"checkpoint {self.path(tag)} does not fit the model: {bad[:4]}")
        state.model.load_state_dict(got)
        if not model_only:
            state.optimizer.load_state_dict(payload["optimizer"])
            state.step = int(payload["step"])
            state.generator.set_state(payload["generator"].cpu())
        meta = {}
        if os.path.exists(self.meta_path(tag)):
            with open(self.meta_path(tag)) as f:
                meta = json.load(f)
        return meta

    def has(self, tag: str) -> bool:
        return os.path.isfile(self.path(tag))


def param_manifest(model: nn.Module) -> dict[str, list[int]]:
    """{state_dict key: shape} of the parameters and BatchNorm statistics,
    the stable identity of a checkpoint. torch's `num_batches_tracked`
    counters are left out: the port's BatchNorm never reads them and flax
    has none."""
    return {k: list(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def resume_train_state(manager: CheckpointManager, state: TrainState,
                       mode: str = "checkpoint") -> tuple[int, float, dict]:
    """Restore `state` in place from `mode` and return (epoch, best_acc,
    meta). On any failure print the reason and start fresh from epoch 0, as
    the JAX package does."""
    try:
        meta = manager.load(mode, state)
        return int(meta.get("epoch", 0)), float(meta.get("best_acc", 0.0)), meta
    except Exception as e:  # noqa: BLE001 — parity: the JAX package restarts
        print(f"resume failed ({e}); starting from epoch 0")
        return 0, 0.0, {}
