"""Host-side data (numpy; PIL only to read image files): the synthetic
DRIVE-like set and its normalisation (`synthetic`), the dataset loaders
(`loaders.get_dataloader`, counterpart of `mm_unet_tpu/data/loaders.py`)
and their transforms (`transforms`), and the reference's mini dataset
(`retina.RetinaDataset`, the root `data.py`'s)."""

from mm_unet_tpu_torch.data.synthetic import DRIVE_MEAN, DRIVE_STD, make_synthetic, synthetic_batch
from mm_unet_tpu_torch.data.loaders import get_dataloader
from mm_unet_tpu_torch.data.retina import RetinaDataset

__all__ = ["DRIVE_MEAN", "DRIVE_STD", "RetinaDataset", "get_dataloader", "make_synthetic",
           "synthetic_batch"]
