"""The port's PVTv2 and FCBFormer against the JAX package, on the CPU.

PVTv2 alone, at its published widths and depths (1, 1, 1, 1): the four
maps at 2x3x64x64 in f32, then, in float64 at 2x3x32x32, every parameter
gradient of sum(map * dout) over the four maps for seeded douts. FCBFormer whole (its
widths and PVTv2-b3's 28 blocks are fixed), in the forms of
`test_torch_port_zoo_conv.py`: eval logits in f32 at 2x3x64x64, one
train-mode pass in float64 with every parameter gradient (the PVT's drop
path is 0; see the test for its size).
Tolerances as there: f32 maps and logits LOGITS_TOL, float64 gradients
F64_TOL per tensor. Plus the zoo's import boundary: none of its modules
imports JAX or the JAX package.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mm_unet_tpu.models import fcbformer as jfcbformer
from mm_unet_tpu.models.pvtv2 import PVTv2 as JPVTv2
from mm_unet_tpu.utils.torch_convert import fcbformer_pairs, pvtv2_pairs
from mm_unet_tpu_torch.models.fcbformer import FCBFormer
from mm_unet_tpu_torch.models.pvtv2 import PVTv2
from mm_unet_tpu_torch.utils.convert import jax_grads_to_torch
from test_torch_port_zoo_conv import (F64_TOL, LOGITS_TOL, check_eval, check_train, grad_errors,
                                      inputs, jax_variables, one_torch_thread)  # noqa: F401
from torch_port_harness import assert_close, load_torch

DEPTHS = (1, 1, 1, 1)
PVT_PAIRS = pvtv2_pairs((), pe_key=lambda i: f"patch_embed{i + 1}",
                        blk_key=lambda i, j: f"block{i + 1}.{j}",
                        norm_key=lambda i: f"norm{i + 1}", depths=DEPTHS)


def test_pvtv2_matches_jax():
    x, _ = inputs(20)
    jm = JPVTv2(depths=DEPTHS)
    v = jax_variables(jm, x.transpose(0, 2, 3, 1), seed=21)
    want = jax.jit(lambda v_, x_: jm.apply(v_, x_))(v, jnp.asarray(x.transpose(0, 2, 3, 1)))
    tm = load_torch(PVTv2(depths=DEPTHS), v, PVT_PAIRS)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, 64, 16, 16), (2, 128, 8, 8), (2, 320, 4, 4),
                                             (2, 512, 2, 2)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), LOGITS_TOL, f"map {i}")

    # the gradients at 32² (maps 8, 4, 2, 1): XLA's float64 convolutions on
    # the CPU take 8.4 s at 64², 2.4 at 32²
    x, _ = inputs(27, size=32)
    want = jax.eval_shape(lambda v_, x_: jm.apply(v_, x_), v,
                          jnp.asarray(x.transpose(0, 2, 3, 1)))
    rng = np.random.default_rng(22)
    douts = [rng.standard_normal(np.shape(w)) for w in want]

    def f(params, x_):
        maps = jm.apply({"params": params}, x_)
        return sum(jnp.vdot(m, jnp.asarray(d)) for m, d in zip(maps, douts))

    with jax.enable_x64():
        args = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                      (v["params"], x.transpose(0, 2, 3, 1)))
        jgrads = jax.device_get(jax.jit(jax.grad(f))(*args))
    tm.double().train()
    maps = tm(torch.from_numpy(x).double())
    sum((m.permute(0, 2, 3, 1) * torch.from_numpy(d)).sum() for m, d in zip(maps, douts)).backward()
    params = dict(tm.named_parameters())
    want_g = {k: t.numpy() for k, t in jax_grads_to_torch(jgrads, PVT_PAIRS, like=params).items()}
    got_g = {k: p.grad.numpy() for k, p in params.items()}
    assert set(want_g) == set(got_g)
    bad = grad_errors(got_g, want_g)
    assert not bad, f"{len(bad)} of {len(want_g)} gradients out of tolerance: {bad[:4]}"


def test_fcbformer_matches_jax(monkeypatch):
    """Eval logits at 2x3x64x64 with PVTv2-b3's 28 blocks; the train pass
    at 1x3x32x32 with the backbone cut to one block a stage on both sides
    (the JAX module's `pvt_v2_b3` patched, the port's `TB.backbone`
    replaced): the b3 depths repeat one block, and XLA's float64
    convolutions on the CPU take ~50 s for the whole model at 64²."""
    x, _ = inputs(23)
    jm = jfcbformer.FCBFormer(num_class=1)
    check_eval(jm, FCBFormer(), jax_variables(jm, x, seed=24), fcbformer_pairs(), x,
               what="FCBFormer")
    monkeypatch.setattr(jfcbformer, "pvt_v2_b3", lambda: JPVTv2(depths=DEPTHS))
    tm = FCBFormer()
    tm.TB.backbone = torch.nn.Sequential(*PVTv2(depths=DEPTHS).children())
    x, y = inputs(25, b=1, size=32)
    check_train(jm, tm, jax_variables(jm, x, seed=26), fcbformer_pairs(DEPTHS), x, y,
                what="FCBFormer")


def test_zoo_modules_never_import_jax():
    code = (
        "import sys\n"
        "from mm_unet_tpu_torch.models.registry import _constructors\n"
        "assert len(_constructors()) == 18\n"
        "import mm_unet_tpu_torch.models.pvtv2\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'mm_unet_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
