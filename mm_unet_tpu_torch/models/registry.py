"""Model factory (counterpart of `mm_unet_tpu/models/registry.py`). MM_Net,
dkDualNet and UM_Net are ported; the rest of the zoo is queued in
ROADMAP.md."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


def _constructors() -> dict:
    from mm_unet_tpu_torch.models.dkdualnet import dkDualNet
    from mm_unet_tpu_torch.models.mm_unet import MM_Net
    from mm_unet_tpu_torch.models.um_net import UM_Net

    return {"MM_Net": MM_Net, "dkDualNet": dkDualNet, "UM_Net": UM_Net}


def give_model(name: str, device: torch.device | str = "cuda",
               generator: Optional[torch.Generator] = None, **kwargs) -> nn.Module:
    """Build `name` with weights drawn from `generator` (on the CPU) and
    return it on `device` in eval mode: the card unless the caller asks for
    the CPU (`device="cpu"`). Keyword arguments go to the model: for MM_Net
    `num_classes`, `num_slices_list`, `depths`, `mamba_dtype`, `remat` and
    `sideout_drop`; for dkDualNet the JAX constructor's `in_channels`,
    `out_channels`, `depths`, `dims`, `kernel_size`, `out_dim`,
    `num_slices_list`, `drop_path_rate`, and `scan_impl` (the Mambas'
    route); for UM_Net the JAX constructor's `num_classes`,
    `num_slices_list`, `out_indices` and `heads`."""
    models = _constructors()
    if name not in models:
        raise NotImplementedError(
            f"model {name!r} is not ported to mm_unet_tpu_torch yet; see ROADMAP.md, "
            "queue 1 (modules to port)"
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"give_model({name!r}): no CUDA device here; the port runs on the card unless "
            "the caller asks for the CPU with device='cpu'"
        )
    return models[name](generator=generator, **kwargs).to(device).eval()
