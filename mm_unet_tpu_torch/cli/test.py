"""Test entry (counterpart of the JAX package's root `test.py`):

    python -m mm_unet_tpu_torch.cli.test [--device cuda|cpu]

Loads the best checkpoint named by `finetune.checkpoint` (or warns and
evaluates at init), then runs sliding-window validation with the seven
metrics and HD95 and prints `test: dice ...`.
"""

from __future__ import annotations

from typing import Optional

from mm_unet_tpu_torch.cli.session import open_session, run
from mm_unet_tpu_torch.evaluate import val_one_epoch
from mm_unet_tpu_torch.train.metrics import HausdorffDistanceMetric, build_metrics
from mm_unet_tpu_torch.utils import ConfigDict


def main(config: Optional[ConfigDict] = None, device: str = "cuda") -> int:
    s = open_session(config, device, log_prefix="test_")
    try:
        name = s.config.finetune.checkpoint
        metrics = build_metrics(include_background=True)
        metrics["hd95"] = HausdorffDistanceMetric(percentile=95)
        if s.manager.has("best"):
            s.manager.load("best", s.state, model_only=True)
            print(f"loaded best checkpoint for {name}", flush=True)
        else:
            print(f"warning: no best checkpoint for {name}; evaluating at init", flush=True)
        _, metric, _ = val_one_epoch(s.model, s.loss_fn, s.inferer, s.val_loader, metrics, 0,
                                     s.num_epochs, 0, s.tracker, s.class_names)
        dice = metric.get("Val/mean dice_metric", float("nan"))
        print(f"test: dice {dice:.4f}; metrics: {metric}", flush=True)
        return 0
    finally:
        s.close()


if __name__ == "__main__":
    run(main, "Evaluate the best checkpoint of the model config.yml (or MMU_CONFIG) names.")
