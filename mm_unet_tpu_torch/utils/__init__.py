"""Utilities: the config, seeding, the log tee, preemption, the scalar
tracker (`tracker`), JAX -> torch weight conversion (`convert`) and the
backbone warm start from a reference `.pth` (`torch_convert`)."""

from mm_unet_tpu_torch.utils.config import ConfigDict, load_config
from mm_unet_tpu_torch.utils.logger import Logger
from mm_unet_tpu_torch.utils.preempt import GracefulShutdown
from mm_unet_tpu_torch.utils.seeding import same_seeds

__all__ = ["ConfigDict", "load_config", "GracefulShutdown", "Logger", "same_seeds"]
