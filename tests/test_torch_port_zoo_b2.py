"""The port's PVTv2-b2 models against the JAX package, on the CPU: DuAT,
PVT_CASCADE, CVC_UNETR and BMANet at their published widths, in the forms
of `test_torch_port_zoo_conv.py`: eval logits in f32 (LOGITS_TOL) at
2x3x32x32, and one train-mode pass in float64 (F64_TOL) with its logits,
loss, every parameter gradient and every updated BatchNorm statistic.

The backbone is cut to one block a stage on both sides (the JAX module's
`pvt_v2_b2` patched for the test, the port's likewise): the b2 depths (3,
4, 6, 3) repeat one block, which `test_torch_port_zoo_pvt.py` holds to JAX
at depth 1, and XLA's float64 convolutions on the CPU grow with each.

DuAT's SBA resizes a map down (1/4 to 1/8, `duat.py:113`), where
`jax.image.resize(..., "linear")` antialiases and the torch reference's
`F.interpolate` does not; the port follows the reference. The test runs the
JAX module with antialiasing off in its `_up`, for the test only, and
states the distance of the unpatched JAX logits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.models import bmanet as jbmanet
from mm_unet_tpu.models import cvc_unetr as jcvc
from mm_unet_tpu.models import duat as jduat
from mm_unet_tpu.models import pvt_cascade as jpvt_cascade
from mm_unet_tpu.models.pvtv2 import PVTv2 as JPVTv2
from mm_unet_tpu.utils.torch_convert import (bmanet_pairs, cvc_unetr_pairs, duat_pairs,
                                             pvt_cascade_pairs)
from mm_unet_tpu_torch.models import bmanet, cvc_unetr, duat, pvt_cascade
from mm_unet_tpu_torch.models.pvtv2 import PVTv2
from test_torch_port_zoo_conv import (check_eval, check_train, inputs, jax_variables,
                                      one_torch_thread)  # noqa: F401

DEPTHS = (1, 1, 1, 1)


@pytest.fixture
def one_block_a_stage(monkeypatch):
    """PVTv2-b2 at depths (1, 1, 1, 1) in both packages' b2 models."""
    for jmod in (jduat, jpvt_cascade, jbmanet):
        monkeypatch.setattr(jmod, "pvt_v2_b2", lambda: JPVTv2(depths=DEPTHS))
    for mod in (duat, pvt_cascade, bmanet):
        monkeypatch.setattr(mod, "pvt_v2_b2", lambda g, cin=3: PVTv2(cin, depths=DEPTHS,
                                                                      generator=g))
    monkeypatch.setattr(jcvc, "PVTv2", functools.partial(JPVTv2, depths=DEPTHS))
    monkeypatch.setattr(cvc_unetr, "PVTv2", functools.partial(PVTv2, depths=DEPTHS))


def check(jm, tm_ctor, pairs, seed, what, tm_prepare=None):
    x, y = inputs(seed, size=32)
    v = jax_variables(jm, x, seed=seed + 1)
    want = check_eval(jm, tm_ctor(), v, pairs, x, what=what)
    check_train(jm, tm_ctor(), v, pairs, x, y, what=what, prepare=tm_prepare)
    return x, v, want


def test_duat_matches_jax(one_block_a_stage, monkeypatch):
    """The unpatched JAX logits lie 1.1e-2 of their largest from the
    patched ones (the antialiased downsample), against LOGITS_TOL between
    the port and the patched JAX."""
    jm = jduat.DuAT(out_channels=1)
    x, _ = inputs(40, size=32)
    v = jax_variables(jm, x, seed=41)
    aa = np.asarray(jax.jit(lambda v_, x_: jm.apply(v_, x_))(v, jnp.asarray(x)))

    def up(t, hw):
        return jax.image.resize(t, (t.shape[0], *hw, t.shape[-1]), method="linear",
                                antialias=False)

    monkeypatch.setattr(jduat, "_up", up)
    _, _, want = check(jm, duat.DuAT, duat_pairs(DEPTHS), 40, "DuAT")
    dist = np.abs(aa - want).max() / np.abs(want).max()
    print(f"DuAT: unpatched JAX logits {dist:.3e} of the largest from the patched")
    assert 1e-3 < dist < 1.0, dist


def test_pvt_cascade_matches_jax(one_block_a_stage):
    jm = jpvt_cascade.PVT_CASCADE(n_class=3, o_class=1)
    check(jm, pvt_cascade.PVT_CASCADE, pvt_cascade_pairs(DEPTHS), 42, "PVT_CASCADE")


def test_cvc_unetr_matches_jax(one_block_a_stage):
    jm = jcvc.CVC_Unetr(out_channels=1)
    check(jm, cvc_unetr.CVC_Unetr, cvc_unetr_pairs(DEPTHS), 44, "CVC_UNETR")


def test_bmanet_matches_jax(one_block_a_stage):
    """BMANet emits probabilities (a sigmoid before its last upsample), as
    the JAX model and the reference do; the DiceFocal loss takes them as
    logits, as in the JAX package."""
    jm = jbmanet.BMANet()
    _, _, want = check(jm, bmanet.BMANet, bmanet_pairs(DEPTHS), 46, "BMANet")
    assert 0.0 <= want.min() and want.max() <= 1.0
