"""What the three entry points build before their loops: the config, the
seeds, the log tee and scalar tracker, the model, the loaders, the inferer,
the loss, the train state and the checkpoint manager.

Under torchrun (`torchrun --nproc_per_node=N -m mm_unet_tpu_torch.cli.train`)
each process joins the data-parallel run (`parallel/mesh.py`) on its own
card; rank 0 alone keeps the log tee, the tracker and the checkpoint
files."""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.nn as nn

from mm_unet_tpu_torch.data.loaders import EDD_KEY_MAPPING, DataLoader, get_dataloader
from mm_unet_tpu_torch.models import give_model_from_config
from mm_unet_tpu_torch.parallel.mesh import DataParallel, init_data_parallel
from mm_unet_tpu_torch.train.checkpoint import CheckpointManager
from mm_unet_tpu_torch.train.inferers import SlidingWindowInferer
from mm_unet_tpu_torch.train.trainer import TrainState, create_train_state, make_loss_fn
from mm_unet_tpu_torch.utils import ConfigDict, GracefulShutdown, Logger, load_config, same_seeds
from mm_unet_tpu_torch.utils.tracker import ScalarTracker

# the loss of the JAX entry points: DiceFocal, MONAI's smoothing
LOSS_FUNCTIONS = {"dice_focal_loss": dict(smooth_nr=0.0, smooth_dr=1e-5)}
LOSS_WEIGHTS = {"dice_focal_loss": 1.0}


@dataclass
class Session:
    config: ConfigDict
    device: torch.device
    logger: Optional[Logger]  # rank 0's alone under data parallelism
    tracker: Optional[ScalarTracker]
    model: nn.Module
    train_loader: DataLoader
    val_loader: DataLoader
    inferer: SlidingWindowInferer
    loss_fn: Callable
    state: TrainState
    manager: CheckpointManager
    class_names: Optional[tuple] = None  # per output channel, for the EDD set
    stop: Optional[GracefulShutdown] = None
    starting_epoch: int = 0
    best_acc: float = 0.0
    best_meta: dict = field(default_factory=dict)

    @property
    def num_epochs(self) -> int:
        return int(self.config.trainer.num_epochs)

    @property
    def dp(self) -> Optional[DataParallel]:
        return self.state.dp

    @property
    def is_main(self) -> bool:
        return self.dp is None or self.dp.rank == 0

    def close(self) -> None:
        """Uninstall the signal handlers, close the tracker and the log tee,
        and leave the process group the session started."""
        if self.stop is not None:
            self.stop.uninstall()
        if self.tracker is not None:
            self.tracker.close()
        if self.logger is not None:
            self.logger.close()
        if self.dp is not None:
            self.dp.close()


def open_session(config: Optional[ConfigDict], device: str | torch.device,
                 log_prefix: str = "") -> Session:
    """`config` None reads `MMU_CONFIG` (default `config.yml`). Raises
    without a CUDA device unless `device` is the CPU. The log directory is
    `logs/<log_prefix><finetune.checkpoint><timestamp>`. Under torchrun the
    process joins the data-parallel run first, on `cuda:LOCAL_RANK`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device here; the entry points run on the card unless "
                           "asked for the CPU (--device cpu)")
    dp, device = init_data_parallel(device)
    if config is None:
        config = load_config(os.environ.get("MMU_CONFIG", "config.yml"))
    seed = same_seeds(int(config.trainer.get("seed", 50)))
    name = config.finetune.checkpoint
    main = dp is None or dp.rank == 0
    logger = Logger(f"{log_prefix}{name}") if main else None  # tees stdout/stderr until close
    try:
        tracker = ScalarTracker(logger.dir) if main else None
        model = give_model_from_config(config, device, torch.Generator().manual_seed(seed))
        train_loader, val_loader = get_dataloader(config)
        size = int(config.dataset[config.trainer.dataset_choose].image_size)
        config.trainer.steps_per_epoch = len(train_loader)
        ranks = "" if dp is None else f"rank {dp.rank} of {dp.world}; "
        print(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'host'}); "
              f"{ranks}model {config.finetune.model_choose}; data {config.trainer.dataset_choose}: "
              f"{len(train_loader.ds)} train / {len(val_loader.ds)} val images at {size}²", flush=True)
        return Session(
            config=config, device=device, logger=logger, tracker=tracker, model=model,
            train_loader=train_loader, val_loader=val_loader,
            inferer=SlidingWindowInferer(roi_size=(size, size), overlap=0.5),
            loss_fn=make_loss_fn(LOSS_FUNCTIONS, LOSS_WEIGHTS),
            state=create_train_state(model, config, seed=seed, dp=dp),
            manager=CheckpointManager("model_store", name, write=main),
            class_names=EDD_KEY_MAPPING if config.trainer.dataset_choose == "EDD_seg" else None,
        )
    except BaseException:
        if logger is not None:
            logger.close()
        if dp is not None:
            dp.close()
        raise


def run(main: Callable[..., int], description: str) -> None:
    """`python -m mm_unet_tpu_torch.cli.<name> [--device ...]`."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; without a card, cuda raises")
    sys.exit(main(device=ap.parse_args().device))
