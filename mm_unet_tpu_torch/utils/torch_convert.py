"""Backbone warm start from a reference `.pth` (counterpart of the warm start
in `mm_unet_tpu/utils/torch_convert.py`: `load_torch_state_dict`,
`load_pvtv2_params`, `load_res2net_params`, `warm_start_variables`).

Five zoo models start from an ImageNet backbone in the reference: FCBFormer
from `pvt_v2_b3.pth`, DuAT, PVT_CASCADE, CVC_UNETR and BMANet from
`pvt_v2_b2.pth` (config.yml's `model_dir`); CFANet's Res2Net-50 v1b
encoder has the loader too. The port's modules carry the reference's
parameter names, so a checkpoint's tensor lands on the tensor of the same
name: no layout changes, unlike the JAX package's flax trees. As there, a
loader copies only the names the reference's backbone defines, and only
where the module holds that name at the same shape; `head.*`, unknown names,
blocks past `depths` and tensors of another shape are skipped, and every
other tensor is left as it was.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence

import torch
import torch.nn as nn

from mm_unet_tpu_torch.models.pvtv2 import OverlapPatchEmbed, PVTv2
from mm_unet_tpu_torch.models.resnet import Res2Net50Encoder

PVT_V2_B2_DEPTHS = (3, 4, 6, 3)
PVT_V2_B3_DEPTHS = (3, 4, 18, 3)
RES2NET50_BLOCKS = (3, 4, 6, 3)

# the modules of a reference PVTv2 block that hold a weight and a bias
_PVT_BLOCK = ("norm1", "norm2", "attn.q", "attn.kv", "attn.proj", "attn.sr", "attn.norm",
              "mlp.fc1", "mlp.fc2", "mlp.dwconv.dwconv")
# a PVTv2 stage's three children, in the reference's order
_PVT_STAGE = ("patch_embed", "block", "norm")
_BN = ("weight", "bias", "running_mean", "running_var")  # not num_batches_tracked


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The checkpoint's tensors on the CPU: a bare state_dict or one under
    "state_dict", anything that is not a tensor dropped. The file is
    unpickled in full, as the JAX package reads it: load only files you
    trust."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def pvtv2_keys(depths: Sequence[int] = PVT_V2_B2_DEPTHS) -> list[str]:
    """The reference `pvt_v2.py` names a PVTv2 of `depths` loads."""
    keys = []
    for i in range(4):
        keys += [f"patch_embed{i + 1}.{m}.{p}" for m in ("proj", "norm")
                 for p in ("weight", "bias")]
        keys += [f"block{i + 1}.{j}.{m}.{p}" for j in range(depths[i]) for m in _PVT_BLOCK
                 for p in ("weight", "bias")]
        keys += [f"norm{i + 1}.weight", f"norm{i + 1}.bias"]
    return keys


def res2net_keys(blocks: Sequence[int] = RES2NET50_BLOCKS) -> list[str]:
    """The reference Res2Net-50 v1b names (`CFANet.py:82-263`) a
    Res2Net50Encoder of `blocks` loads: the deep stem, then each block's
    convs and BatchNorms (weight, bias and running statistics)."""
    convs = ["conv1.0", "conv1.3", "conv1.6"]
    bns = ["conv1.1", "conv1.4", "bn1"]
    for i, n in enumerate(blocks):
        for j in range(n):
            t = f"layer{i + 1}.{j}"
            convs += [f"{t}.{m}" for m in ("conv1", "convs.0", "convs.1", "convs.2", "conv3",
                                           "downsample.1")]
            bns += [f"{t}.{m}" for m in ("bn1", "bns.0", "bns.1", "bns.2", "bn3",
                                         "downsample.2")]
    return [f"{c}.weight" for c in convs] + [f"{b}.{p}" for b in bns for p in _BN]


def _is_pvtv2(module: nn.Module) -> bool:
    """A PVTv2, or its children flattened into a Sequential (FCBFormer's
    backbone, `fcbformer.py:108`)."""
    return isinstance(module, PVTv2) or (
        isinstance(module, nn.Sequential) and len(module) == 12
        and isinstance(module[0], OverlapPatchEmbed))


def _reference_name(name: str) -> str:
    """A name in a PVTv2 or in its flattened Sequential -> the reference's:
    child 3i + s of the Sequential is patch_embed, block, norm (s = 0, 1, 2)
    of stage i + 1."""
    head, _, rest = name.partition(".")
    if not head.isdigit():
        return name
    k = int(head)
    return f"{_PVT_STAGE[k % 3]}{k // 3 + 1}.{rest}"


def _copy(tensors: Mapping[str, torch.Tensor], sd: Mapping[str, torch.Tensor],
          keys: Sequence[str]) -> int:
    """Copy sd[key] into tensors[key] for each key both hold at one shape,
    onto the tensor's own device and dtype; the count copied."""
    n = 0
    with torch.no_grad():
        for key in keys:
            dst, src = tensors.get(key), sd.get(key)
            if dst is not None and src is not None and dst.shape == src.shape:
                dst.copy_(src)
                n += 1
    return n


def load_pvtv2_params(backbone: nn.Module, sd: Mapping[str, torch.Tensor],
                      depths: Sequence[int] = PVT_V2_B2_DEPTHS) -> int:
    """Load a reference PVTv2 state_dict into `backbone` (a PVTv2, or
    FCBFormer's Sequential of its children) in place; the count of tensors
    replaced."""
    tensors = {_reference_name(k): v for k, v in backbone.state_dict(keep_vars=True).items()}
    return _copy(tensors, sd, pvtv2_keys(depths))


def load_res2net_params(encoder: Res2Net50Encoder, sd: Mapping[str, torch.Tensor],
                        blocks: Sequence[int] = RES2NET50_BLOCKS) -> int:
    """Load a reference Res2Net-50 v1b state_dict into `encoder` in place,
    BatchNorms' running statistics included; the count of tensors
    replaced."""
    return _copy(encoder.state_dict(keep_vars=True), sd, res2net_keys(blocks))


def _model_dir(config: Mapping) -> tuple[Optional[str], str]:
    """(model name, the `model_dir` of its config section, or "")."""
    from mm_unet_tpu_torch.models.registry import _model_kwargs
    from mm_unet_tpu_torch.utils.config import ConfigDict

    name = (config.get("finetune") or {}).get("model_choose")
    if not name:
        return None, ""
    return name, _model_kwargs(ConfigDict(config), name).get("model_dir") or ""


def warm_start(model: nn.Module, config: Mapping) -> int:
    """Load the checkpoint that the selected model's config section names
    as `model_dir` into the model's backbone, in place, as the reference's
    constructors do (`DuAT.py:332-337`, `FCBFormer/models.py:111`): into
    the first PVTv2 (b3's depths when the file has a `block3.7.` tensor,
    else b2's), else into the first Res2Net50Encoder. Returns the count of
    tensors replaced: 0, with nothing changed, when no file is named or the
    path is not a file. A file that does not load raises."""
    name, path = _model_dir(config)
    if not path or not os.path.isfile(path):
        return 0
    sd = load_torch_state_dict(path)
    pvt = next((m for m in model.modules() if _is_pvtv2(m)), None)
    if pvt is not None:
        depths = PVT_V2_B3_DEPTHS if any("block3.7." in k for k in sd) else PVT_V2_B2_DEPTHS
        n, what = load_pvtv2_params(pvt, sd, depths), f"PVTv2 depths {depths}"
    else:
        encoder = next((m for m in model.modules() if isinstance(m, Res2Net50Encoder)), None)
        if encoder is None:
            return 0
        n, what = load_res2net_params(encoder, sd), "Res2Net50Encoder"
    print(f"warm_start: loaded {n} tensors of {path} into {name}'s {what}", flush=True)
    return n
