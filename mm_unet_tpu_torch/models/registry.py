"""Model factory (counterpart of `mm_unet_tpu/models/registry.py`). Only
MM_Net is ported so far; the rest of the zoo is queued in ROADMAP.md."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


def give_model(name: str, device: torch.device | str = "cpu",
               generator: Optional[torch.Generator] = None, **kwargs) -> nn.Module:
    """Build `name` with weights drawn from `generator` (on the CPU) and
    return it on `device` in eval mode. Keyword arguments go to the model:
    for MM_Net `num_classes`, `num_slices_list`, `depths`, `mamba_dtype`,
    `remat` and `sideout_drop`."""
    if name != "MM_Net":
        raise NotImplementedError(
            f"model {name!r} is not ported to mm_unet_tpu_torch yet; see ROADMAP.md, "
            "queue 1 (modules to port)"
        )
    from mm_unet_tpu_torch.models.mm_unet import MM_Net

    return MM_Net(generator=generator, **kwargs).to(device).eval()
