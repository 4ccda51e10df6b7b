"""The port's HWAUNETR against the JAX package, on the CPU.

HWAUNETR at 128² (its v3 slices, 64, 32, 16 and 8, divide the four
stages' 32², 16², 8² and 4² tokens) with narrow dims (8, 16, 24, 32) and
hidden size 32: the eval logits in f32, and one train-mode pass (DiceFocal)
in float64 with its logits, loss and every parameter gradient, in the
forms of `test_torch_port_zoo_conv.py`. Its Mambas take the port's megakernel route
(on the CPU, the plain `mamba_fused_scan_ref`) and the JAX module's grouped
scan; both keep the scan in f32 under float64 inputs, which leaves the
float64 pass well inside the zoo's limits (largest readings: f32 eval
logits 2.7e-7, float64 gradients 3.6e-8 of their tensor).

The q/k/v domains: the JAX Mamba's o_2 (the reverse direction, flipped
back) and o_3 (the slice direction, un-interleaved), which the MFA block
feeds to its attention, against the port's. `HWABlock`, which HWAUNETR does
not call, on its own: its nearest resize has half-pixel centres.
"""

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from mm_unet_tpu.models import hwaunetr as jhwaunetr
from mm_unet_tpu.models.mamba import Mamba as JMamba
from mm_unet_tpu.utils.torch_convert import hwaunetr_pairs, mamba_pairs
from mm_unet_tpu_torch.models.hwaunetr import HWABlock, HWAUNETR
from mm_unet_tpu_torch.models.mamba import Mamba
from test_torch_port_zoo_conv import (LOGITS_TOL, FlaxWith, check_eval, check_train, inputs,
                                      jax_variables, one_torch_thread)  # noqa: F401
from torch_port_harness import assert_close, load_torch

DIMS, HIDDEN = (8, 16, 24, 32), 32


def test_hwaunetr_matches_jax():
    x, y = inputs(30, size=128)
    kw = dict(in_chans=3, out_chans=1, dims=DIMS, hidden_size=HIDDEN)
    jm = jhwaunetr.HWAUNETR(**kw)
    v = jax_variables(jm, x, seed=31)
    pairs = hwaunetr_pairs(dims=DIMS)
    check_eval(jm, HWAUNETR(**kw), v, pairs, x, what="HWAUNETR")
    x, y = x[:1], y[:1]
    check_train(jm, HWAUNETR(**kw), v, pairs, x, y, what="HWAUNETR")


def test_hwaunetr_qkv_domains_match_jax():
    """The v3 Mamba's four outputs, the port's against the JAX module's at
    the same weights: out, o_1, o_2 in the reference's (flipped) domain and
    o_3 un-interleaved, which the MFA block takes as q, k and v."""
    rng = np.random.default_rng(32)
    tokens = rng.standard_normal((2, 64, 8)).astype(np.float32)
    jm = JMamba(d_model=8, bimamba_type="v3", nslices=4)
    v = jax_variables(jm, tokens, seed=33)
    want = jax.jit(lambda v_, t: jm.apply(v_, t))(v, jnp.asarray(tokens))
    tm = load_torch(torch.nn.ModuleDict({"mamba": Mamba(8, bimamba_type="v3", nslices=4)}),
                    v, mamba_pairs((), "mamba", 8))
    with torch.no_grad():
        got = tm["mamba"](torch.from_numpy(tokens))
    for name, g, w in zip(("out", "o_1", "o_2", "o_3"), got, want):
        assert_close(g.numpy(), np.asarray(w), LOGITS_TOL, name)
    # o_2 and o_3 are not the forward direction's domain: a port returning
    # the reverse scan unflipped, or o_3 interleaved, would differ here
    o2, o3 = got[2].numpy(), got[3].numpy()
    il = o3.reshape(2, 16, 4, 16).transpose(0, 1, 3, 2).reshape(2, 16, 64)
    for wrong, w in ((o2[..., ::-1], want[2]), (il, want[3])):
        w = np.asarray(w)
        assert np.abs(wrong - w).max() > 0.1 * np.abs(w).max()


def hwablock_pairs(in_chans: int, n_scales: int) -> list:
    """JAX HWABlock (flax Conv_i in call order: each channel's scale convs,
    then its fuse conv) -> the port's downs.{c}.{k} and fuse.{c}."""
    pairs, i = [(("weights",), "weights", "raw")], 0
    for c in range(in_chans):
        for k in range(n_scales):
            pairs += [((f"Conv_{i}", "kernel"), f"downs.{c}.{k}.weight", "conv"),
                      ((f"Conv_{i}", "bias"), f"downs.{c}.{k}.bias", "raw")]
            i += 1
        pairs += [((f"Conv_{i}", "kernel"), f"fuse.{c}.weight", "conv"),
                  ((f"Conv_{i}", "bias"), f"fuse.{c}.bias", "raw")]
        i += 1
    return pairs


def test_hwablock_matches_jax(monkeypatch):
    """At 22², where the stride-4 conv floors to 5² and resizing 5 -> 22
    by half-pixel centres (`nearest-exact`) picks other rows than torch's
    `nearest`: the port matches JAX, and `nearest` would not.

    The JAX module's strided convs take flax's default "SAME" padding
    (`hwaunetr.py:98`), which pads 22 to 24 for the stride-4 conv (6², not
    the torch reference's floor, 5²); the port floors, as the reference's
    `nn.Conv2d(1, 1, ks, stride=ks)` does. The test runs the JAX module with
    "VALID" as the strided convs' default, for the test only, and states the
    distance of the unpatched JAX output: 1.17 of the largest output here
    (the sizes agree wherever the input divides by each kernel size)."""
    x = np.random.default_rng(34).standard_normal((2, 22, 22, 3)).astype(np.float32)
    jm = jhwaunetr.HWABlock(in_chans=3)
    v = jax_variables(jm, x, seed=35)
    run = jax.jit(lambda v_, x_: jm.apply(v_, x_))
    same = np.asarray(run(v, jnp.asarray(x)))
    monkeypatch.setattr(jhwaunetr, "nn", FlaxWith(Conv=functools.partial(flax.linen.Conv,
                                                                           padding="VALID")))
    want = np.asarray(jax.jit(lambda v_, x_: jm.apply(v_, x_))(v, jnp.asarray(x)))
    dist = np.abs(same - want).max() / np.abs(want).max()
    assert 0.1 < dist < 2.0, dist
    print(f"unpatched JAX HWABlock: {dist:.3f} of the largest output")
    tm = load_torch(HWABlock(in_chans=3), v, hwablock_pairs(3, 4))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tm(xt).permute(0, 2, 3, 1).numpy()
    assert_close(got, want, LOGITS_TOL, "HWABlock")
    with torch.no_grad():
        d = tm.downs[0][2](xt[:, :1])
        exact = F.interpolate(d, size=(22, 22), mode="nearest-exact")
        plain = F.interpolate(d, size=(22, 22), mode="nearest")
    assert d.shape[-1] == 5 and (exact - plain).abs().max() > 1e-3


def test_hwaunetr_kernel_launches():
    """Depths (1, 1, 1, 1): four MFA blocks, one v3 Mamba each, three
    fused scans per Mamba; a train step adds one backward per scan."""
    model = HWAUNETR(in_chans=3, out_chans=1)
    assert model.kernel_launches_per_forward() == {"mamba_fused_scan": 12}
    assert model.kernel_launches_per_train_step() == {"mamba_fused_scan": {"fwd": 12, "bwd": 12}}
    assert all(m.use_mega and m.d_state == 16 for m in model.modules() if isinstance(m, Mamba))
