"""Training a language model through the program's own epoch loop, as
`entries/train_loop.py` does an image model's (one step in flight,
`HostCopy`, the fused AdamW of `create_train_state`, the loss the
configuration names), on batches {"tokens": (batch, size) int64} drawn
uniformly over the configuration's vocabulary from the seed and resident
on the card. The metric dict is empty: a language model's step has no
segmentation statistics. The rate counts sequences where an image cell
counts images.

After the first steps, the start state and the first step's logits, which
only the check reads, wait on the host: on the card they would take 8 GiB
(at Jamba2-3B's 1.60 B parameters and 8,192 x 65,536 logits) that the
program never holds, beside a step that needs ~64 GiB."""

from __future__ import annotations

import torch

from entries import train_loop
from harness.spec import sub_seed


def token_pool(n_batches: int, batch: int, size: int, vocab: int, seed: int,
               device) -> list[dict]:
    """n_batches distinct batches {"tokens": (batch, size)} of ids uniform
    over [0, vocab), int64 on `device`."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "tokens"))
    ids = torch.randint(0, vocab, (n_batches * batch, size), generator=g, device=device)
    return [{"tokens": ids[i * batch:(i + 1) * batch].contiguous()} for i in range(n_batches)]


class Entry(train_loop.Entry):
    def setup(self) -> None:
        from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn

        t, cfg = self.traffic, self.cfg
        model = self.build_model()
        opt = cfg["optimizer"]
        # the learning rate held at lr: a warm-up of one epoch of a million steps
        config = {"trainer": dict(lr=opt["lr"], warmup=1, num_epochs=2, steps_per_epoch=10**6,
                                  weight_decay=opt["weight_decay"], optimizer="adamw")}
        self.dropout_seed = sub_seed(self.seed, "dropout")
        self.state = create_train_state(model, config, seed=self.dropout_seed)
        self.loss_fn = make_loss_fn({cfg["loss"]: {}}, {cfg["loss"]: 1.0})
        self.metrics = {}
        self.pool = token_pool(t["pool"], t["batch"], t["size"],
                               cfg["model_kwargs"]["vocab_size"], self.seed, self.device)
        self.prog = self._first_steps(int(t["ref_steps"]))
        self.next = int(t["ref_steps"])
        self.state0 = {n: v.cpu() for n, v in self.state0.items()}
        self.prog["logits"] = self.prog["logits"].cpu()
