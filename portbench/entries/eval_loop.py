"""Evaluating an image set through the program's own validation loop,
`mm_unet_tpu_torch/evaluate.py::val_one_epoch`: the default predictor over
a `SlidingWindowInferer` (one 512² window per 512² image, so a call is one
forward of the whole batch), the loss on the stitched logits, and the seven
metrics on the thresholded predictions, one batch in flight.

Set-up evaluates each batch of the pool once, which builds and warms every
shape. The window evaluates the pool one batch after another until the time
is up. The inferer is wrapped to keep the logits of one call of each pool
batch, the call drawn from the seed; every call's loss comes back from
`val_one_epoch` itself."""

from __future__ import annotations

import gc
import random

import torch

from entries.train_loop import Cycle, Entry as TrainEntry
from harness.data import synthetic_pool
from harness.refrun import reference_eval
from harness.spec import sub_seed


class Keeper:
    """The inferer, keeping the logits of the calls `keep` names ({call
    index: pool batch}) and the pool batch of every call."""

    def __init__(self, inferer, keep: dict):
        self.inferer, self.keep, self.kept, self.calls = inferer, keep, {}, 0

    def __call__(self, images, predictor):
        out = self.inferer(images, predictor)
        if self.calls in self.keep:
            self.kept[self.keep[self.calls]] = out
        self.calls += 1
        return out


class Entry(TrainEntry):
    kind = "serve"

    def setup(self) -> None:
        from mm_unet_tpu_torch.train.inferers import SlidingWindowInferer
        from mm_unet_tpu_torch.train.metrics import build_metrics
        from mm_unet_tpu_torch.train.trainer import make_loss_fn

        t, cfg, dev = self.traffic, self.cfg, self.device
        self.model = self.build_model().eval()
        self.loss_fn = make_loss_fn({cfg["loss"]: {}}, {cfg["loss"]: 1.0})
        self.metrics = build_metrics()
        size = int(t["size"])
        self.inferer = SlidingWindowInferer((size, size), overlap=t["overlap"],
                                            sw_batch_size=t["sw_batch_size"])
        self.pool = synthetic_pool(t["pool"], t["batch"], size, self.seed, dev)
        # one call of each pool batch among its first `sample_visits` visits
        rng = random.Random(sub_seed(self.seed, "sample"))
        n = len(self.pool)
        self.keep = {rng.randrange(int(t["sample_visits"])) * n + b: b for b in range(n)}
        self.window_losses = []
        self.next = 0
        self.run(count=n)  # warm-up: each batch once

    def run(self, deadline: float | None = None, count: int | None = None,
            record: bool = False) -> int:
        """Evaluate the pool until `deadline` or for `count` calls; with
        `record`, keep each call's loss with its pool batch and the sampled
        calls' logits. Returns the images evaluated."""
        from mm_unet_tpu_torch.evaluate import val_one_epoch

        start = self.next
        loader = Cycle(self.pool, start, deadline, count)
        inferer = Keeper(self.inferer, self.keep if record else {})
        with self.quiet():
            _, _, losses = val_one_epoch(self.model, self.loss_fn, inferer, loader, self.metrics)
        if record:
            n = len(self.pool)
            self.window_losses += [((start + i) % n, v) for i, v in enumerate(losses)]
            self.kept = inferer.kept
        self.next = loader.i
        return loader.served * int(self.traffic["batch"])

    def free(self) -> None:
        del self.model, self.loss_fn, self.metrics
        gc.collect()
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def check(self) -> tuple[dict, dict]:
        missing = set(self.keep.values()) - set(self.kept)
        if missing:
            raise SystemExit(f"portbench: the window made no sampled call of pool batches "
                             f"{sorted(missing)}; lengthen the window or lower sample_visits")
        prog = {"losses": self.window_losses, "logits": self.kept}
        ref = reference_eval(self.cell, self.state0, dict(enumerate(self.pool)), self.device,
                             int(self.traffic["ref_rows"]))
        return prog, ref
