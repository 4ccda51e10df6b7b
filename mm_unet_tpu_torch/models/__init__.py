"""Models: MM_Net and its blocks."""

from mm_unet_tpu_torch.models.registry import give_model

__all__ = ["give_model"]
