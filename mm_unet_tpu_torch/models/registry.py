"""Model factory (counterpart of `mm_unet_tpu/models/registry.py`): by name
(`give_model`) or by `config.finetune.model_choose` with the keyword
arguments of the config's `models.<name>.branch1` or `branch5` section
(`give_model_from_config`). Every name of the JAX package's registry is
ported: MM_Net, dkDualNet, UM_Net, HWAUNETR, UNet, ConvUNeXt (also as
ConvUNetXt), CFPNet, UNETR, TransUNet, SWINUNETR, FCBFormer, DuAT,
PVT_CASCADE, CVC_UNETR, BMANet, CFANet and VANet. Beside them, the port's
own language models, which the JAX registry lacks: Jamba."""

from __future__ import annotations

import inspect
from typing import Optional

import torch
import torch.nn as nn


def _constructors() -> dict:
    from mm_unet_tpu_torch.models.bmanet import BMANet
    from mm_unet_tpu_torch.models.cfanet import CFANet
    from mm_unet_tpu_torch.models.cfpnet import CFPNet
    from mm_unet_tpu_torch.models.convunext import ConvUNeXt
    from mm_unet_tpu_torch.models.cvc_unetr import CVC_Unetr
    from mm_unet_tpu_torch.models.dkdualnet import dkDualNet
    from mm_unet_tpu_torch.models.duat import DuAT
    from mm_unet_tpu_torch.models.fcbformer import FCBFormer
    from mm_unet_tpu_torch.models.hwaunetr import HWAUNETR
    from mm_unet_tpu_torch.models.mm_unet import MM_Net
    from mm_unet_tpu_torch.models.pvt_cascade import PVT_CASCADE
    from mm_unet_tpu_torch.models.swin_unetr import SwinUNETR
    from mm_unet_tpu_torch.models.transunet import TransUNet
    from mm_unet_tpu_torch.models.um_net import UM_Net
    from mm_unet_tpu_torch.models.unet import UNet
    from mm_unet_tpu_torch.models.unetr import UNETR
    from mm_unet_tpu_torch.models.vanet import VANet

    return {"MM_Net": MM_Net, "dkDualNet": dkDualNet, "UM_Net": UM_Net, "HWAUNETR": HWAUNETR,
            "UNet": UNet, "ConvUNeXt": ConvUNeXt, "ConvUNetXt": ConvUNeXt, "CFPNet": CFPNet,
            "UNETR": UNETR, "TransUNet": TransUNet, "SWINUNETR": SwinUNETR,
            "FCBFormer": FCBFormer, "DuAT": DuAT, "PVT_CASCADE": PVT_CASCADE,
            "CVC_UNETR": CVC_Unetr, "BMANet": BMANet, "CFANet": CFANet, "VANet": VANet}


def _lm_constructors() -> dict:
    """The port's language models, built by name beside the JAX registry's."""
    from mm_unet_tpu_torch.models.jamba import JambaForCausalLM

    return {"Jamba": JambaForCausalLM}


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
    `num_slices_list`, `out_indices` and `heads`. The zoo takes the JAX
    constructors' arguments: UNet `n_channels`, `num_classes`, `bilinear`;
    ConvUNeXt `in_channels`, `num_classes`, `bilinear`, `base_c`; CFPNet
    `classes`, `block_1`, `block_2`; UNETR `in_channels`, `out_channels`,
    `img_size`, `feature_size`, `hidden_size`, `mlp_dim`, `num_heads`,
    `num_layers`, `patch_size`, `spatial_dims`; TransUNet `img_dim`,
    `in_channels`, `out_channels` (its width), `head_num`, `mlp_dim`,
    `block_num`, `patch_dim`, `class_num`; SWINUNETR `img_size`,
    `in_channels`, `out_channels`, `feature_size`, `depths`, `num_heads`,
    `window`, `use_checkpoint`, `spatial_dims`; FCBFormer `size`,
    `num_class`, `model_dir`; HWAUNETR `in_chans`, `out_chans`,
    `kernel_sizes`, `depths`, `dims`, `num_slices_list`, `hidden_size`;
    DuAT `in_channels`, `out_channels`, `dim`, `dims`, `model_dir`;
    PVT_CASCADE `n_class` (input channels), `o_class`, `model_dir`;
    CVC_UNETR `in_channels`, `out_channels`, `dims`, `out_dim`,
    `kernel_size`, `mlp_ratio`, `model_dir`; BMANet `channel` (its width),
    `out_channel`, `model_dir`; CFANet `in_class`, `out_class`, `channel`;
    VANet `cfg`, `embed_dims`, `depths`, `mlp_ratios`, `num_heads`,
    `strides`, `proj_drop`, `attn_drop`, `drop_path`, `num_class`. Jamba
    takes the keys of a Jamba `config.json` (`models/jamba.py`) and is built
    on `device` itself, its weights drawn there from a generator seeded from
    `generator`: a billion weights drawn on the CPU would take minutes. So
    a language model's weights depend on `device` as well as on
    `generator`: the same generator gives other weights on the card than
    on the CPU, where every other model's are the same on both. Any other
    name outside the JAX package's registry raises NotImplementedError.
    `_lm_constructors` is kept apart from `_constructors`, which holds the
    JAX registry's names alone (`tests/test_torch_port_cli.py` and
    `chip_smoke.py`'s registry phase walk it)."""
    models, lms = _constructors(), _lm_constructors()
    if name not in models and name not in lms:
        raise NotImplementedError(
            f"model {name!r} is not ported to mm_unet_tpu_torch: the JAX package's registry "
            f"lacks it too (it has {sorted(models)}); see ROADMAP.md"
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"give_model({name!r}): no CUDA device here; the port runs on the card unless "
            "the caller asks for the CPU with device='cpu'"
        )
    if name in lms:
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        seed = int(torch.randint(1 << 62, (), generator=g))
        with torch.device(device):
            return lms[name](generator=torch.Generator(device).manual_seed(seed), **kwargs).eval()
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
# the zoo's own names for config.yml's `num_classes`, never an input
# channel count (PVT_CASCADE's `n_class`, CFANet's `in_class`, HWAUNETR's
# `in_chans`) nor a width (BMANet's `channel`)
_CLASS_COUNT_KEYS = ("class_num", "classes", "out_channels", "num_class", "o_class",
                     "out_channel", "out_class", "out_chans")
# the constructor argument that fixes the input size, where one does
_INPUT_SIZE_KEYS = {"TransUNet": "img_dim", "UNETR": "img_size"}


def _model_kwargs(config, name: str) -> dict:
    models_cfg = config.get("models") or {}
    entry = models_cfg.get(_CONFIG_KEYS.get(name, name), models_cfg.get(name, {})) or {}
    use5 = config.trainer.get("dataset_choose", "") == "EDD_seg" and name not in _BRANCH1_ONLY
    kwargs = dict(entry.get("branch5" if use5 else "branch1", {}) or {})
    for key in _UNUSED.get(name, ()):
        kwargs.pop(key, None)
    return kwargs


def _constructor_kwargs(config, name: str, kwargs: dict) -> dict:
    """config.yml's sections name the class count `num_classes` for every
    model; the zoo's constructors call it `class_num`, `classes`,
    `out_channels`, `num_class`, `o_class`, `out_channel`, `out_class` or
    `out_chans` (with those sections the JAX package's
    TransUNet, UNETR, SWINUNETR, FCBFormer and CFPNet raise a TypeError).
    Rename it to the constructor's own, unless the section gives that too;
    and give TransUNet and UNETR the dataset's image size where the
    section does not fix it."""
    ctor = _constructors().get(name)
    if ctor is None:
        return kwargs
    params = inspect.signature(ctor).parameters
    kwargs = dict(kwargs)
    if "num_classes" in kwargs and "num_classes" not in params:
        own = next((k for k in _CLASS_COUNT_KEYS if k in params), None)
        if own is not None and own not in kwargs:
            kwargs[own] = kwargs.pop("num_classes")
    size_key = _INPUT_SIZE_KEYS.get(name)
    dataset = (config.get("dataset") or {}).get(config.trainer.get("dataset_choose", ""), {})
    if size_key and size_key not in kwargs and "image_size" in (dataset or {}):
        kwargs[size_key] = int(dataset["image_size"])
    return kwargs


def give_model_from_config(config, device: torch.device | str = "cuda",
                           generator: Optional[torch.Generator] = None) -> nn.Module:
    """`give_model(config.finetune.model_choose, device, generator, **kwargs)`
    with the keyword arguments of the config's branch1 section (branch5 for
    EDD_seg, except the models that keep branch1), as the JAX package's
    `give_model(config)` reads them, the class count renamed to the model's
    own keyword and the input size given where a model fixes it
    (`_constructor_kwargs`)."""
    name = config.finetune.model_choose
    kwargs = _constructor_kwargs(config, name, _model_kwargs(config, name))
    return give_model(name, device, generator, **kwargs)
