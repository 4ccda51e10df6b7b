"""Training entry (counterpart of the JAX package's root `train.py`):

    python -m mm_unet_tpu_torch.cli.train [--device cuda|cpu]

Config-driven: per-step loss lines, the seven metrics per epoch, the best
checkpoint on `Val/mean f1` and a `checkpoint` after every epoch, each with
{epoch, best_acc, best_class} metadata, `trainer.resume: true` to continue
from `checkpoint`, and on SIGTERM/SIGINT a `checkpoint` of the interrupted
epoch (redone on resume) and exit code 0. `setup` builds the run and
`fit` runs its epochs; `main` is the two.

Data parallel on N cards (or N CPU processes with `--device cpu`):

    torchrun --nproc_per_node=N -m mm_unet_tpu_torch.cli.train

with ZeRO-1 unless `trainer.zero1: false`. Every rank validates the whole
validation set and takes rank 0's f1, so all agree on the best; a signal
that reaches any rank stops all of them at the same step boundary.
"""

from __future__ import annotations

from typing import Optional

from mm_unet_tpu_torch.cli.session import Session, open_session, run
from mm_unet_tpu_torch.evaluate import val_one_epoch
from mm_unet_tpu_torch.train.checkpoint import resume_train_state
from mm_unet_tpu_torch.train.loop import stop_requested, train_one_epoch
from mm_unet_tpu_torch.train.metrics import build_metrics
from mm_unet_tpu_torch.utils import ConfigDict, GracefulShutdown


def setup(config: Optional[ConfigDict] = None, device: str = "cuda") -> Session:
    """The run before its first epoch: on resume the state restored from
    `checkpoint` with its step at the epoch's first, and the preemption
    handlers installed (`Session.close` removes them)."""
    s = open_session(config, device)
    if s.config.trainer.get("resume", False):
        s.starting_epoch, s.best_acc, s.best_meta = resume_train_state(s.manager, s.state)
        s.state.step = s.starting_epoch * len(s.train_loader)
    s.stop = GracefulShutdown().install()
    return s


def fit(s: Session) -> int:
    """Train from `s.starting_epoch` to `trainer.num_epochs`, validating
    after each epoch; closes the session. Returns 0."""
    try:
        metrics = build_metrics(include_background=True)
        val_metrics = build_metrics(include_background=True)
        val_step = 0
        for epoch in range(s.starting_epoch, s.num_epochs):
            train_one_epoch(s.state, s.loss_fn, s.train_loader, metrics, epoch, s.num_epochs,
                            tracker=s.tracker, stop=s.stop)
            if stop_requested(s.stop, s.dp):
                # epoch NOT +1: the interrupted epoch is redone on resume
                s.manager.save_checkpoint(s.state, {
                    "epoch": epoch, "best_acc": s.best_acc,
                    "best_class": s.best_meta.get("best_class", {}),
                })
                print(f"[preempt] checkpoint saved at epoch {epoch}; exiting", flush=True)
                return 0
            mean_f1, metric, losses = val_one_epoch(
                s.model, s.loss_fn, s.inferer, s.val_loader, val_metrics, epoch, s.num_epochs,
                val_step, s.tracker, s.class_names)
            if s.dp is not None:  # every rank takes rank 0's result
                mean_f1, metric = s.dp.broadcast_object((mean_f1, metric))
            val_step += len(losses)
            meta = {"epoch": epoch + 1, "best_acc": s.best_acc, "best_class": metric}
            if mean_f1 > s.best_acc:
                s.best_acc = mean_f1
                meta["best_acc"] = s.best_acc
                s.manager.save_best(s.state, meta)
                if s.is_main:
                    print(f"new best f1 {s.best_acc:.4f} at epoch {epoch + 1}", flush=True)
            s.manager.save_checkpoint(s.state, meta)
        print(f"best f1: {s.best_acc:.4f}", flush=True)
        return 0
    finally:
        s.close()


def main(config: Optional[ConfigDict] = None, device: str = "cuda") -> int:
    return fit(setup(config, device))


if __name__ == "__main__":
    run(main, "Train the model config.yml (or MMU_CONFIG) names.")
