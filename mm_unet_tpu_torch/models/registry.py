"""Model factory (counterpart of `mm_unet_tpu/models/registry.py`): by name
(`give_model`) or by `config.finetune.model_choose` with the keyword
arguments of the config's `models.<name>.branch1` or `branch5` section
(`give_model_from_config`). MM_Net, dkDualNet and UM_Net are ported; the
rest of the zoo is queued in ROADMAP.md."""

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


# model_choose -> config.models section key, as the JAX package's registry
_CONFIG_KEYS = {
    "TransUNet": "trans_unet", "CFPNet": "cfp_net", "UNETR": "u_netr",
    "SWINUNETR": "swin_unetr", "DuAT": "duat", "UNet": "unet", "CFANet": "cfa_net",
    "PVT_CASCADE": "pvt_ca", "UM_Net": "um_net", "CVC_UNETR": "cvc_unetr",
    "BMANet": "bmanet", "VANet": "vanet",
}
# models that never switch to branch5 (the 5-class EDD set keeps branch1)
_BRANCH1_ONLY = {"UM_Net", "MM_Net", "dkDualNet", "FRUNet", "ConvUNetXt", "UNet3Plus", "ATTUNet"}
# config keys the JAX MM_Net accepts for config parity and never reads
_UNUSED = {"MM_Net": ("out_indices", "heads")}


def _model_kwargs(config, name: str) -> dict:
    models_cfg = config.get("models") or {}
    entry = models_cfg.get(_CONFIG_KEYS.get(name, name), models_cfg.get(name, {})) or {}
    use5 = config.trainer.get("dataset_choose", "") == "EDD_seg" and name not in _BRANCH1_ONLY
    kwargs = dict(entry.get("branch5" if use5 else "branch1", {}) or {})
    for key in _UNUSED.get(name, ()):
        kwargs.pop(key, None)
    return kwargs


def give_model_from_config(config, device: torch.device | str = "cuda",
                           generator: Optional[torch.Generator] = None) -> nn.Module:
    """`give_model(config.finetune.model_choose, device, generator, **kwargs)`
    with the keyword arguments of the config's branch1 section (branch5 for
    EDD_seg, except the models that keep branch1), as the JAX package's
    `give_model(config)` reads them."""
    name = config.finetune.model_choose
    return give_model(name, device, generator, **_model_kwargs(config, name))
