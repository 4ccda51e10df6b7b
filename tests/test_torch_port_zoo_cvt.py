"""The port's VANet against the JAX package, on the CPU, at its published
widths and depths (CvT-13's (1, 2, 10)), in the forms of
`test_torch_port_zoo_conv.py`: eval logits in f32 at 2x3x32x32
(LOGITS_TOL), and one train-mode pass in float64 (F64_TOL) with its
logits, loss, every parameter gradient and every updated BatchNorm
statistic. Both sides are built with dropout, attention dropout and drop
path at 0, the identity they are in eval mode; the port's dropout sites
and rates are checked on their own. VANet emits probabilities (a sigmoid
before its last upsample).

The JAX module builds the interpolation matrices of its mask resizes and
final upsample in f32 (`layers.py:21-71`); the test runs it with float64
matrices, for the test only, as `test_cfanet_matches_jax` does.
"""

import numpy as np
import jax.numpy as jnp

from mm_unet_tpu.models import vanet as jvanet
from mm_unet_tpu.utils.torch_convert import vanet_pairs
from mm_unet_tpu_torch.models.layers import Dropout, DropPath
from mm_unet_tpu_torch.models.vanet import VANet
from test_torch_port_zoo_conv import (check_eval, check_train, inputs, jax_variables,
                                      one_torch_thread)  # noqa: F401
from test_torch_port_zoo_res2net import align_corners_matrix, resize_align_corners_f64

NO_DROP = dict(proj_drop=0.0, attn_drop=0.0, drop_path=0.0)


def half_pixel_matrix(n: int, m: int) -> np.ndarray:
    """The (m, n) matrix of torch's bilinear `F.interpolate`
    (align_corners=False, no antialiasing) in float64."""
    pos = np.clip((np.arange(m) + 0.5) * (n / m) - 0.5, 0, n - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, n - 1)
    w = np.zeros((m, n))
    np.add.at(w, (np.arange(m), lo), 1.0 - (pos - lo))
    np.add.at(w, (np.arange(m), hi), pos - lo)
    return w


def resize_torch_f64(x, out_hw):
    """`layers.resize_bilinear_torch` with float64 matrices."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    mh = jnp.asarray(half_pixel_matrix(x.shape[1], out_hw[0]), x.dtype)
    mw = jnp.asarray(half_pixel_matrix(x.shape[2], out_hw[1]), x.dtype)
    return jnp.einsum("bhwc,ph,qw->bpqc", x, mh, mw)


def test_vanet_matches_jax(monkeypatch):
    monkeypatch.setattr(jvanet, "resize_bilinear_align_corners", resize_align_corners_f64)
    monkeypatch.setattr(jvanet, "resize_bilinear_torch", resize_torch_f64)
    x, y = inputs(60, size=32)
    jm = jvanet.VANet(**NO_DROP)
    v = jax_variables(jm, x, seed=61)
    want = check_eval(jm, VANet(**NO_DROP), v, vanet_pairs(), x, what="VANet")
    assert 0.0 <= want.min() and want.max() <= 1.0
    check_train(jm, VANet(**NO_DROP), v, vanet_pairs(), x, y, what="VANet")


def test_vanet_dropout_sites_and_rates():
    """The JAX model's rates (`vanet.py:175-208`): 0.1 after each MLP layer
    and the output projection and on the attention weights; drop path 0.1
    × j / (depth - 1) over each encoder stage (CvT stage 2's second half
    keeps its rates in decoder stage 0), 0.1 in the decoder's new blocks."""
    m = VANet()
    paths = {n: mod.p for n, mod in m.named_modules() if isinstance(mod, DropPath)}
    want = {"encoder_stage0.blocks.0": 0.0, "encoder_stage1.blocks.0": 0.0,
            "encoder_stage1.blocks.1": 0.1, "decoder_stage1_blk.0": 0.1,
            "decoder_stage1_blk.1": 0.1, "decoder_stage2_blk.0": 0.1}
    want |= {f"encoder_stage2_blk.{i}": 0.1 * i / 9 for i in range(5)}
    want |= {f"decoder_stage0_blk.{j}": 0.1 * (5 + j) / 9 for j in range(5)}
    assert {n[:-len(".drop_path")]: p for n, p in paths.items()} == want
    drops = [mod.p for mod in m.modules() if isinstance(mod, Dropout)]
    assert len(drops) == 4 * 16 and set(drops) == {0.1}
    assert sum(hasattr(mod, "alpha") for mod in m.modules()) == 5 + 2 + 1
