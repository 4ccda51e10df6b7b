"""Verify entry (counterpart of the JAX package's root `verify.py`):

    python -m mm_unet_tpu_torch.cli.verify [--device cuda|cpu]

Loads the best checkpoint named by `finetune.checkpoint` when there is
one, fine-tunes for `trainer.verify_warmup` epochs (default 1), then runs
sliding-window validation with the seven metrics and HD95 and prints
`verify: best dice ...`. Under `torchrun --nproc_per_node=N` the warm-up
epochs are data parallel, as `cli.train`'s.
"""

from __future__ import annotations

from typing import Optional

from mm_unet_tpu_torch.cli.session import open_session, run
from mm_unet_tpu_torch.evaluate import val_one_epoch
from mm_unet_tpu_torch.train.loop import train_one_epoch
from mm_unet_tpu_torch.train.metrics import HausdorffDistanceMetric, build_metrics
from mm_unet_tpu_torch.utils import ConfigDict


def main(config: Optional[ConfigDict] = None, device: str = "cuda") -> int:
    s = open_session(config, device, log_prefix="verify_")
    try:
        name = s.config.finetune.checkpoint
        metrics = build_metrics(include_background=True)
        metrics["hd95"] = HausdorffDistanceMetric(percentile=95)
        if s.manager.has("best"):
            s.manager.load("best", s.state, model_only=True)
            print(f"loaded best checkpoint for {name}", flush=True)
        train_metrics = build_metrics(include_background=True)
        for epoch in range(int(s.config.trainer.get("verify_warmup", 1))):
            train_one_epoch(s.state, s.loss_fn, s.train_loader, train_metrics, epoch,
                            s.num_epochs, tracker=s.tracker)
        _, metric, _ = val_one_epoch(s.model, s.loss_fn, s.inferer, s.val_loader, metrics, 0,
                                     s.num_epochs, 0, s.tracker, s.class_names)
        dice = metric.get("Val/mean dice_metric", float("nan"))
        print(f"verify: best dice {dice:.4f}; metrics: {metric}", flush=True)
        return 0
    finally:
        s.close()


if __name__ == "__main__":
    run(main, "Fine-tune and evaluate the best checkpoint of the model config.yml "
              "(or MMU_CONFIG) names.")
