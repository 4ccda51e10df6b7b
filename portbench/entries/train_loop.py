"""Training through the program's own epoch loop,
`mm_unet_tpu_torch/train/loop.py::train_one_epoch` (one step in flight,
batches staged and scalars read back through `HostCopy`), with the loss of
`trainer.make_loss_fn`, the seven metrics of `build_metrics` and the fused
AdamW of `create_train_state`.

Set-up builds one train state from the seeded weights and drives its
first `ref_steps` steps through `train_one_epoch`, each on its own batch of
the pool, reading the loss of each, the model's output in the first (a
forward hook, removed after it), the first gradient as AdamW holds it (its
first moment after one step over 1 - beta1) and the parameters after the
last. The window goes on training that same state over the pool, one
batch after another, until the time is up."""

from __future__ import annotations

import contextlib
import gc
import importlib
import sys
import time

import torch

from harness.data import synthetic_pool
from harness.refrun import reference_train
from harness.spec import Cell, sub_seed
from harness.weights import seeded_state

# each hand-written kernel family's launch counters in the port: the
# function whose `launches` and `bwd_launches` count them, by module
COUNTERS = {
    "mamba_fused": ("mm_unet_tpu_torch.ops.mamba_fused", "mamba_fused_scan"),
    "tap_conv": ("mm_unet_tpu_torch.ops.tap_conv", "tap_conv"),
    "selective_scan": ("mm_unet_tpu_torch.ops.chunked_scan", "selective_scan_chunked"),
}


class Cycle:
    """The pool's batches in turn from `start`, until `deadline` (host clock)
    or `count` batches; `served` counts what it gave."""

    def __init__(self, pool, start: int, deadline: float | None = None,
                 count: int | None = None):
        self.pool, self.i, self.deadline, self.count, self.served = pool, start, deadline, count, 0

    def __iter__(self):
        while ((self.deadline is None or time.perf_counter() < self.deadline)
               and (self.count is None or self.served < self.count)):
            yield self.pool[self.i % len(self.pool)]
            self.i += 1
            self.served += 1


class Entry:
    kind = "train"
    own_init = False  # calibrate.py's look at the model's own initialisation
    keep_tensors = False  # calibrate.py's look leaf by leaf: keep the first
    # gradient and the changes, after the first step and after the last

    def __init__(self, cell: Cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.traffic, self.cfg = cell.traffic, cell.config

    def quiet(self):
        """The program's own prints go to standard error."""
        return contextlib.redirect_stdout(sys.stderr)

    def build_model(self):
        """The port's model on the card with the seed's weights
        (`seeded_state`), kept as `state0` for the reference; with
        `own_init`, the model's own initialisation drawn from the seed."""
        from mm_unet_tpu_torch.models import give_model

        cfg, dev = self.cfg, self.device
        torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
        torch.backends.cudnn.allow_tf32 = cfg["tf32"]
        init = sub_seed(self.seed, "init") if self.own_init else 0
        model = give_model(cfg["model"], device=dev, generator=torch.Generator().manual_seed(init),
                           **cfg["model_kwargs"])
        if self.own_init:
            self.state0 = {n: v.detach().clone() for n, v in model.state_dict().items()}
            return model
        with torch.device("meta"):
            spec = self.cell.reference().build(cfg).state_dict()
        self.state0 = seeded_state(spec, self.seed, dev)
        model.load_state_dict(self.state0, strict=True)
        return model

    def setup(self) -> None:
        from mm_unet_tpu_torch.train.metrics import build_metrics
        from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn

        t, cfg, dev = self.traffic, self.cfg, self.device
        model = self.build_model()
        opt = cfg["optimizer"]
        # the learning rate held at lr: a warm-up of one epoch of a million steps
        config = {"trainer": dict(lr=opt["lr"], warmup=1, num_epochs=2, steps_per_epoch=10**6,
                                  weight_decay=opt["weight_decay"], optimizer="adamw")}
        self.dropout_seed = sub_seed(self.seed, "dropout")
        self.state = create_train_state(model, config, seed=self.dropout_seed)
        self.loss_fn = make_loss_fn({cfg["loss"]: {}}, {cfg["loss"]: 1.0})
        self.metrics = build_metrics()
        self.pool = synthetic_pool(t["pool"], t["batch"], t["size"], self.seed, dev)
        self.prog = self._first_steps(int(t["ref_steps"]))
        self.next = int(t["ref_steps"])

    def _norms(self, tensors: dict) -> dict:
        return {n: float(v.norm()) for n, v in tensors.items()}

    def _first_steps(self, steps: int) -> dict:
        """The first `steps` steps through the loop, each on its own batch."""
        from mm_unet_tpu_torch.train.loop import train_one_epoch

        state = self.state
        named = dict(state.model.named_parameters())
        losses = StepLosses()
        beta1 = state.optimizer.param_groups[0]["betas"][0]
        kept = []
        hook = state.model.register_forward_hook(lambda m, i, out: kept.append(out.detach()))
        with self.quiet():
            try:
                train_one_epoch(state, self.loss_fn, Cycle(self.pool, 0, count=1), self.metrics,
                                tracker=losses)
            finally:
                hook.remove()
            grad_t = {n: state.optimizer.state[p]["exp_avg"] / (1 - beta1)
                      for n, p in named.items()}
            change1_t = {n: p.detach() - self.state0[n] for n, p in named.items()}
            out = {"grad": self._norms(grad_t), "change1": self._norms(change1_t)}
            if self.keep_tensors:
                out.update(grad_t={n: v.cpu() for n, v in grad_t.items()},
                           change1_t={n: v.cpu() for n, v in change1_t.items()})
            del grad_t, change1_t
            if steps > 1:
                train_one_epoch(state, self.loss_fn, Cycle(self.pool, 1, count=steps - 1),
                                self.metrics, tracker=losses)
        change_t = {n: p.detach() - self.state0[n] for n, p in named.items()}
        out["change"] = self._norms(change_t)
        if self.keep_tensors:
            out["change_t"] = {n: v.cpu() for n, v in change_t.items()}
        return {"losses": losses.values, "logits": kept[0], **out}

    def run(self, deadline: float | None = None, count: int | None = None) -> int:
        """Train over the pool until `deadline` or for `count` steps; returns
        the images trained."""
        from mm_unet_tpu_torch.train.loop import train_one_epoch

        loader = Cycle(self.pool, self.next, deadline, count)
        with self.quiet():
            train_one_epoch(self.state, self.loss_fn, loader, self.metrics)
        self.next = loader.i
        return loader.served * int(self.traffic["batch"])

    def counters(self) -> dict:
        """{family: (forward, backward) launches so far} (`COUNTERS`)."""
        out = {}
        for fam, (module, name) in COUNTERS.items():
            fn = getattr(importlib.import_module(module), name)
            out[fam] = (fn.launches, fn.bwd_launches)
        return out

    def free(self) -> None:
        del self.state, self.loss_fn, self.metrics
        gc.collect()
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def check(self) -> tuple[dict, dict]:
        """(the program's readings, the reference's) after `free`."""
        steps = int(self.traffic["ref_steps"])
        ref = reference_train(self.cell, self.state0, self.pool[:steps], self.dropout_seed,
                              self.device)
        return self.prog, ref


class StepLosses:
    """A tracker for `train_one_epoch` that keeps each step's total loss."""

    def __init__(self):
        self.values = []

    def log(self, scalars: dict, step: int) -> None:
        if "Train/total_loss" in scalars:
            self.values.append(float(scalars["Train/total_loss"]))
