"""Deterministic seeding (counterpart of `mm_unet_tpu/utils/seeding.py`)."""

from __future__ import annotations

import random

import numpy as np
import torch


def same_seeds(seed: int = 50) -> int:
    """Seed Python's, NumPy's and torch's global generators (every device's)
    and return the seed. The model's weights and the dropout masks come from
    generators seeded explicitly from it."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
