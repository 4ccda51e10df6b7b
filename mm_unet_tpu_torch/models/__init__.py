"""Models: MM_Net, dkDualNet, UM_Net, the zoo (UNet, ConvUNeXt, CFPNet, UNETR,
TransUNet, SwinUNETR, PVTv2 and FCBFormer) and their blocks."""

from mm_unet_tpu_torch.models.registry import give_model, give_model_from_config

__all__ = ["give_model", "give_model_from_config"]
