"""The port's transformer zoo models against the JAX package, on the CPU:
UNETR (hidden 96, feature size 16), TransUNet (img_dim 64, out_channels
32, 2 blocks) and SwinUNETR (feature size 12; with checkpointing, the eval
logits and the gradients against its own without), each at 2x3x64x64, in the forms of
`test_torch_port_zoo_conv.py` (eval logits in f32; one train-mode pass in
float64 with every parameter gradient and BatchNorm statistic). Plus
TransUNet's dropout, SwinUNETR's cached masks, and the input size that
UNETR and TransUNet fix at construction.

TransUNet: the JAX module builds its LayerNorms at flax's eps 1e-6 and its
GELU in the tanh form (`transunet.py:49,51,55`), where the reference has
1e-5 and the exact GELU; the port is pinned to the reference, and the test
runs the JAX module with both patched in for the test only, stating the
distance of the unpatched JAX logits. Its train pass holds dropout at the
identity on both sides (the port's Dropout modules in eval mode, the JAX
module's Dropout patched deterministic); the port's dropout is tested on
its own.
"""

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.models import swin_unetr as jswin
from mm_unet_tpu.models import transunet as jtransunet
from mm_unet_tpu.models import unetr as junetr
from mm_unet_tpu.utils.torch_convert import swin_unetr_pairs, transunet_pairs, unetr_pairs
from mm_unet_tpu_torch.models.layers import Dropout
from mm_unet_tpu_torch.models.swin_unetr import SwinUNETR
from mm_unet_tpu_torch.models.transunet import TransUNet
from mm_unet_tpu_torch.models.unetr import UNETR
from mm_unet_tpu_torch.train.losses import dice_focal_loss
from test_torch_port_zoo_conv import (F64_TOL, FlaxWith, check_eval, check_train, exact_gelu,
                                      inputs, jax_variables, one_torch_thread)  # noqa: F401
from torch_port_harness import assert_close, load_torch

UNETR_TINY = dict(img_size=64, feature_size=16, hidden_size=96, mlp_dim=192, num_heads=4)
TRANSUNET_TINY = dict(img_dim=64, out_channels=32, head_num=4, mlp_dim=128, block_num=2)
SWIN_TINY = dict(feature_size=12)


def test_unetr_matches_jax():
    x, y = inputs(10)
    jm = junetr.UNETR(out_channels=1, **UNETR_TINY)
    v = jax_variables(jm, x, seed=11)
    pairs = unetr_pairs(embed=96, heads=4)
    check_eval(jm, UNETR(**UNETR_TINY), v, pairs, x, what="UNETR")
    check_train(jm, UNETR(**UNETR_TINY), v, pairs, x, y, what="UNETR")


def _dropout_off(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.eval()


def _eval64(jm, variables, x):
    with jax.enable_x64():
        args = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), (variables, x))
        return np.asarray(jax.jit(lambda v_, x_: jm.apply(v_, x_))(*args))


def test_transunet_matches_jax(monkeypatch):
    """The JAX module with LayerNorm eps 1e-5 and the exact GELU patched
    in. In float64, its unpatched eval logits lie 5.1e-6 of their largest
    from the patched ones here (the GELU 5.1e-6, the eps 2.7e-7: the
    decoder's BatchNorm in eval mode damps the ViT's share), the port's
    ~1e-14."""
    x, y = inputs(12)
    jm = jtransunet.TransUNet(class_num=1, **TRANSUNET_TINY)
    v = jax_variables(jm, x, seed=13)
    pairs = transunet_pairs(embedding_dim=256, head_num=4, block_num=2)
    unpatched = _eval64(jm, v, x)
    monkeypatch.setattr(jtransunet, "nn", FlaxWith(
        gelu=exact_gelu, LayerNorm=functools.partial(flax.linen.LayerNorm, epsilon=1e-5),
        Dropout=lambda rate, deterministic: flax.linen.Dropout(rate, deterministic=True)))
    check_eval(jm, TransUNet(**TRANSUNET_TINY), v, pairs, x, what="TransUNet")
    pinned = _eval64(jm, v, x)
    port = load_torch(TransUNet(**TRANSUNET_TINY), v, pairs).double()
    with torch.no_grad():
        assert_close(port(torch.from_numpy(x).double()).numpy(), pinned, F64_TOL, "TransUNet f64")
    dist = np.abs(unpatched - pinned).max() / np.abs(pinned).max()
    assert dist > 1e-6, dist
    check_train(jm, TransUNet(**TRANSUNET_TINY), v, pairs, x, y, what="TransUNet",
                prepare=_dropout_off)


def test_transunet_dropout_rate_scale_and_generator():
    """Each of the 1 + 3 x blocks Dropout(0.1) sites takes the generator
    that `set_dropout_generator` sets; a site keeps ~90% of the elements,
    scaled by 1/0.9, and one seed draws one mask."""
    model = TransUNet(**TRANSUNET_TINY)
    sites = [m for m in model.modules() if isinstance(m, Dropout)]
    assert len(sites) == 1 + 3 * TRANSUNET_TINY["block_num"] and {m.p for m in sites} == {0.1}
    g = torch.Generator()
    model.set_dropout_generator(g)
    assert all(m.generator is g for m in sites)
    x = torch.ones(4, 64, 256)
    out = sites[0].train()(x)
    kept = out != 0
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.9))
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    x, _ = inputs(14, b=1)
    runs = []
    for seed in (5, 5, 6):
        g.manual_seed(seed)
        with torch.no_grad():
            runs.append(model.train()(torch.from_numpy(x)))
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def _swin_pairs(use_checkpoint):
    """`swin_unetr_pairs` for the JAX module: with checkpointing its
    blocks are named `CheckpointSwinBlock_i` (flax's `nn.remat`)."""
    pairs = swin_unetr_pairs(feature_size=12)
    if not use_checkpoint:
        return pairs
    return [((("Checkpoint" + fp[0]) if fp[0].startswith("SwinBlock_") else fp[0], *fp[1:]),
             tk, kind) for fp, tk, kind in pairs]


def test_swin_unetr_matches_jax():
    """At 64² the stages' maps are 32, 16, 8 and 4: the first three pad to
    35, 21 and 14 and shift, the last pads to 7 and does not."""
    x, y = inputs(15)
    jm = jswin.SwinUNETR(out_channels=1, use_checkpoint=False, **SWIN_TINY)
    v = jax_variables(jm, x, seed=16)
    pairs = _swin_pairs(False)
    check_eval(jm, SwinUNETR(use_checkpoint=False, **SWIN_TINY), v, pairs, x, what="SwinUNETR")
    check_train(jm, SwinUNETR(use_checkpoint=False, **SWIN_TINY), v, pairs, x, y,
                what="SwinUNETR")


def test_swin_unetr_checkpointed_matches_jax():
    """use_checkpoint=True: the eval logits against the JAX module's (its
    blocks under `nn.remat`), and the port's train-mode gradients equal to
    those without checkpointing, bit for bit."""
    x, y = inputs(18)
    jm = jswin.SwinUNETR(out_channels=1, use_checkpoint=True, **SWIN_TINY)
    v = jax_variables(jm, x, seed=19)
    pairs = _swin_pairs(True)
    check_eval(jm, SwinUNETR(**SWIN_TINY), v, pairs, x, what="SwinUNETR")
    grads = []
    for use_checkpoint in (True, False):
        tm = load_torch(SwinUNETR(use_checkpoint=use_checkpoint, **SWIN_TINY), v, pairs).train()
        dice_focal_loss(tm(torch.from_numpy(x)), torch.from_numpy(y)).backward()
        grads.append({k: p.grad for k, p in tm.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])


def test_swin_masks_are_built_once_per_size():
    model = SwinUNETR(use_checkpoint=False, **SWIN_TINY).eval()
    x = torch.from_numpy(inputs(17, b=1)[0])
    with torch.no_grad():
        model(x)
        first = {name: dict(m._masks) for name, m in model.named_modules() if hasattr(m, "_masks")}
        model(x)
    assert len(first) == 8 and all(len(masks) == 1 for masks in first.values())
    for name, m in model.named_modules():
        if hasattr(m, "_masks"):
            assert m._masks.keys() == first[name].keys()
            assert all(m._masks[k] is first[name][k] for k in m._masks)


@pytest.mark.parametrize("name,model", [("UNETR", lambda: UNETR(**UNETR_TINY)),
                                        ("TransUNet", lambda: TransUNet(**TRANSUNET_TINY))])
def test_input_size_is_fixed_at_construction(name, model):
    with pytest.raises(ValueError, match=f"{name} was built for 64x64 inputs.*got 96x96"):
        model()(torch.zeros(1, 3, 96, 96))
