"""JAX variables -> torch state_dict, by the reference's pair tables.

The tables in `mm_unet_tpu/utils/torch_convert.py` (`mm_net_pairs`,
`mmconv_pairs`, `mamba_pairs`, `bn_pairs`, `conv_pairs`, ...) map each flax
variable path to the torch reference's key and a layout kind, in the
direction torch -> flax. `jax_to_torch_state_dict` inverts each kind, so the
same tables load JAX weights into this package's modules, which carry the
torch reference's names. A table's function kinds are inverted as gathers
(`_gather_index`): the function, applied to the torch tensor's element
indices, says which torch element each flax element holds, so the flax
values are scattered back; several entries may fill one torch tensor (the
fused qkv weight of `mhdpa_pairs`), and together they must fill each
element exactly once. The dt_proj weight's shift, the one function kind
that is not a gather, is undone as such. The caller passes the pair list;
this module imports neither jax nor the JAX package. The JAX package has
no table for the Mamba LM: `lm_pairs` is the port's own, in the same form.
"""

from __future__ import annotations

import math
import re
from typing import Iterable, Mapping, Optional

import numpy as np
import torch

_DT_PROJ = re.compile(r"(^|\.)dt_proj(_b|_s)?\.weight$")


def _conv(k):  # flax (kH, kW, I, O) -> torch (O, I, kH, kW)
    return np.transpose(k, (3, 2, 0, 1))


def _conv_t(k):  # undo the transpose and spatial flip of the "convT" kind
    return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))


_INVERSE = {
    "conv": _conv,
    "convT": _conv_t,
    "dense": lambda k: np.transpose(k, (1, 0)),  # (I, O) -> (O, I)
    "raw": lambda k: k,
    "conv1d_dw": lambda k: k[:, None, :],  # (D, W) -> (D, 1, W)
}


def _gather_index(kind, shape: tuple) -> np.ndarray:
    """For a function kind that only moves elements (slices, transposes,
    reshapes, permutations): the torch tensor's flat element index that each
    element of the flax leaf holds."""
    idx = np.asarray(kind(np.arange(math.prod(shape)).reshape(shape)))
    if not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(f"function kind {kind} is not a gather of the torch tensor")
    return idx


def _from_flax(entries: list, like: Optional[Mapping], grads: bool) -> dict[str, np.ndarray]:
    """entries (torch key, kind, flax value) -> {torch key: value}. A string
    kind's layout is inverted; the dt_proj function kind unshifts the weight
    (a gradient passes unchanged: d(w - c)/dw = 1); any other function kind
    is scattered back through `_gather_index`, which needs the torch shape
    from `like`, and the entries of one torch key must together fill each of
    its elements exactly once."""
    out, scattered = {}, {}
    for tkey, kind, val in entries:
        if isinstance(kind, str) or _DT_PROJ.search(tkey):
            if tkey in out or tkey in scattered:
                raise ValueError(f"torch key {tkey} mapped twice")
            if isinstance(kind, str):
                out[tkey] = _INVERSE[kind](val)
            else:  # stored shifted by +dt_rank**-0.5 (mm_unet_tpu/models/mamba.py:119-120)
                out[tkey] = val if grads else val - val.shape[1] ** -0.5
        else:
            if tkey in out:
                raise ValueError(f"torch key {tkey} mapped twice")
            scattered.setdefault(tkey, []).append((kind, val))
    for tkey, parts in scattered.items():
        if like is None or tkey not in like:
            raise ValueError(f"the function kind of {tkey} needs the torch shape: pass `like`")
        shape = tuple(like[tkey].shape)
        flat = np.zeros(math.prod(shape), np.result_type(*(v for _, v in parts)))
        hits = np.zeros(flat.size, np.int64)
        for kind, val in parts:
            idx = _gather_index(kind, shape)
            if idx.shape != val.shape:
                raise ValueError(f"{tkey}: the function kind gives {idx.shape}, the leaf is "
                                 f"{val.shape}")
            flat[idx.ravel()] = val.ravel()
            np.add.at(hits, idx.ravel(), 1)
        if not (hits == 1).all():
            raise ValueError(f"{tkey}: the pairs fill {int((hits > 0).sum())} of {flat.size} "
                             f"elements, {int((hits > 1).sum())} more than once")
        out[tkey] = flat.reshape(shape)
    return out


def _leaves(tree: Mapping, prefix=()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _torch(arrays: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    # a writable C-ordered copy (np.ascontiguousarray would make 0-d 1-d)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in arrays.items()}


def jax_grads_to_torch(grads_np: Mapping, pairs: Iterable,
                       like: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> dict[str, torch.Tensor]:
    """Gradients of the flax params (nested dicts of numpy arrays, the
    `params` tree's structure) -> {torch parameter name: gradient}, by the
    same pair tables. Only each kind's layout is inverted: the dt_proj
    function kind stores the weight shifted by a constant, whose derivative
    is the identity, so its gradient passes unchanged; the gather kinds
    need `like` (a torch state_dict or named parameters) for their shapes.
    BatchNorm statistics (mean/var) have no gradients and are skipped.
    Strict like `jax_to_torch_state_dict`: every param pair must find its
    gradient."""
    leaves = _leaves(grads_np)
    entries, used, missing = [], set(), []
    for fpath, tkey, kind in pairs:
        if fpath[-1] in ("mean", "var"):
            continue
        path = tuple(fpath)
        if path not in leaves:
            missing.append(path)
            continue
        used.add(path)
        entries.append((tkey, kind, leaves[path]))
    unused = sorted(set(leaves) - used)
    if missing or unused:
        raise ValueError(f"pair table mismatch: {len(missing)} missing gradients "
                         f"{missing[:5]}, {len(unused)} unused gradients {unused[:5]}")
    return _torch(_from_flax(entries, like, grads=True))


def jax_to_torch_state_dict(variables_np: Mapping, pairs: Iterable,
                            like: Optional[Mapping[str, torch.Tensor]] = None
                            ) -> dict[str, torch.Tensor]:
    """variables_np: {"params": ..., "batch_stats": ...} nested dicts of
    numpy arrays. pairs: (flax_path, torch_key, kind) as the tables give
    them; leaves named mean/var are read from batch_stats and become
    running_mean/running_var. Strict: every pair's leaf must exist, every
    leaf must be used, and, when `like` (a torch state_dict) is given, the
    keys and shapes must be exactly its own (BatchNorm's
    num_batches_tracked aside). The gather kinds need `like`."""
    leaves = {}
    for coll in ("params", "batch_stats"):
        leaves.update({(coll,) + p: v for p, v in _leaves(variables_np.get(coll, {})).items()})
    entries, used, missing = [], set(), []
    for fpath, tkey, kind in pairs:
        coll = "batch_stats" if fpath[-1] in ("mean", "var") else "params"
        path = (coll,) + tuple(fpath)
        if path not in leaves:
            missing.append(path)
            continue
        used.add(path)
        entries.append((tkey, kind, leaves[path]))
    unused = sorted(set(leaves) - used)
    if missing or unused:
        raise ValueError(f"pair table mismatch: {len(missing)} missing flax leaves "
                         f"{missing[:5]}, {len(unused)} unused leaves {unused[:5]}")
    sd = _torch(_from_flax(entries, like, grads=False))
    if like is not None:
        want = {k: tuple(v.shape) for k, v in like.items()
                if not k.endswith("num_batches_tracked")}
        got = {k: tuple(v.shape) for k, v in sd.items()}
        if want != got:
            diff = sorted(set(want.items()) ^ set(got.items()))
            raise ValueError(f"state_dict mismatch (key, shape) first of {len(diff)}: {diff[:5]}")
    return sd


def mamba_pairs(fpath: tuple, tkey: str, d_model: int) -> list:
    """A one-direction Mamba's entries, in the form of the JAX package's
    `torch_convert.mamba_pairs`: the flax params carry the torch names, and
    `dt_proj_weight` is stored shifted by +dt_rank**-0.5 (the function kind,
    which `_invert` undoes)."""
    shift = math.ceil(d_model / 16) ** -0.5

    def dt_shift(w):
        return np.asarray(w) + shift

    return [((*fpath, "in_proj_weight"), f"{tkey}.in_proj.weight", "raw"),
            ((*fpath, "out_proj_weight"), f"{tkey}.out_proj.weight", "raw"),
            ((*fpath, "conv1d_weight"), f"{tkey}.conv1d.weight", "conv1d_dw"),
            ((*fpath, "conv1d_bias"), f"{tkey}.conv1d.bias", "raw"),
            ((*fpath, "x_proj_weight"), f"{tkey}.x_proj.weight", "raw"),
            ((*fpath, "dt_proj_weight"), f"{tkey}.dt_proj.weight", dt_shift),
            ((*fpath, "dt_proj_bias"), f"{tkey}.dt_proj.bias", "raw"),
            ((*fpath, "A_log"), f"{tkey}.A_log", "raw"),
            ((*fpath, "D"), f"{tkey}.D", "raw")]


def lm_pairs(n_layer: int, d_model: int, rms_norm: bool) -> list:
    """The JAX `MambaLMHeadModel` <- the port's (`models/lm.py`): the
    embedding, each Block's norm (`LayerNorm_0`, or a bias-less `RMSNorm_0`)
    and one-direction Mamba, and `norm_f`. The head is tied to the
    embedding and has no entry of its own."""
    def norm(fpath, tkey):
        return ([((*fpath, "scale"), f"{tkey}.weight", "raw")]
                + ([] if rms_norm else [((*fpath, "bias"), f"{tkey}.bias", "raw")]))

    p = [(("backbone", "embedding", "embedding"), "backbone.embedding.weight", "raw")]
    for i in range(n_layer):
        fpath, tkey = ("backbone", f"layers_{i}"), f"backbone.layers.{i}"
        p += norm((*fpath, "RMSNorm_0" if rms_norm else "LayerNorm_0"), f"{tkey}.norm")
        p += mamba_pairs((*fpath, "Mamba_0"), f"{tkey}.mixer", d_model)
    return p + norm(("backbone", "norm_f"), "backbone.norm_f")
