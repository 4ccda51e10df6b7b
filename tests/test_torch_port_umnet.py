"""The port's UM_Net and its blocks against the JAX package, on the CPU: the
ResNet-34 encoder (eval, and train mode with its BatchNorm statistics),
SELayer, HPPF, RCG, NonLocalBlock, ALGM, the decoder and side-output
blocks, and the whole UM_Net's eval logits at 1x3x64x64 through
`um_net_pairs`; every parameter's and input's gradient of each block and
of the encoder in eval mode, each held to its own tensor; plus the registry
entry, the launch counts, the default device and the import boundary.

Weights move across with `jax_to_torch_state_dict` and the reference's pair
tables (`um_net_pairs` re-rooted at each block, `resnet34_encoder_pairs`;
NonLocalBlock, ALGM and SELayer have no table, so the tests list their
pairs), with random BatchNorm running statistics. JAX on the CPU runs its
Mamba's exact associative scan and its DSConvs' 2-hot matmul; the port runs
its kernels' plain versions. f32. Tolerances, as max |port - jax| <= tol *
(1 + max |jax|): 1e-4 for a block (summation orders), 5e-4 for the encoder
and the whole model (through ~60 layers), BatchNorm statistics 1e-4; the
gradients as max |port - jax| <= 1e-4 * max |jax| of each tensor.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.models import um_net as jum
from mm_unet_tpu.models.resnet import ResNet34Encoder as JResNet34Encoder
from mm_unet_tpu.utils.torch_convert import (bn_pairs, conv_pairs, dense_pairs, dsconv_pairs,
                                             resnet34_encoder_pairs, um_net_pairs)
from mm_unet_tpu_torch.models import give_model
from mm_unet_tpu_torch.models import um_net as tum
from mm_unet_tpu_torch.models.resnet import ResNet34Encoder
from mm_unet_tpu_torch.utils.convert import jax_grads_to_torch, jax_to_torch_state_dict
from torch_port_harness import assert_close, load_torch, randomize_batch_stats, sub_pairs

PAIRS = um_net_pairs()


def _init(module, *inputs, seed=0):
    variables = jax.jit(module.init)(jax.random.PRNGKey(seed), *(jnp.asarray(x) for x in inputs))
    return randomize_batch_stats(variables, np.random.default_rng(seed))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _check_block(jm, tm, inputs, pairs, what, tol=1e-4):
    v = _init(jm, *inputs)
    want = jax.jit(jm.apply)(v, *(jnp.asarray(x) for x in inputs))
    load_torch(tm, v, pairs)
    with torch.no_grad():
        got = tm(*(_nchw(x) for x in inputs))
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(_nhwc(g), np.asarray(w), tol, f"{what} output {i}")
    else:
        assert_close(_nhwc(got), np.asarray(want), tol, what)


def _block_grads(jm, tm, inputs, pairs, seed=0):
    """(port, JAX) gradients of sum(out * dout) with respect to every
    parameter (by torch name) and every input (`input.i`), eval mode, for a
    seeded random dout of each output."""
    v = _init(jm, *inputs)
    xs = [jnp.asarray(x) for x in inputs]
    outs = jax.jit(jm.apply)(v, *xs)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    douts = [_rn(seed + 100 + i, *o.shape) for i, o in enumerate(outs)]

    def f(params, *xs_):
        out = jm.apply({**v, "params": params}, *xs_)
        out = out if isinstance(out, (list, tuple)) else [out]
        return sum(jnp.vdot(o, jnp.asarray(d)) for o, d in zip(out, douts))

    gp, *gx = jax.jit(jax.grad(f, argnums=tuple(range(1 + len(xs)))))(v["params"], *xs)
    want = {k: g.numpy() for k, g in jax_grads_to_torch(jax.device_get(gp), pairs).items()}
    want.update({f"input.{i}": np.asarray(g) for i, g in enumerate(gx)})
    load_torch(tm, v, pairs).eval()
    ts = [_nchw(x).requires_grad_(True) for x in inputs]
    out = tm(*ts)
    out = out if isinstance(out, (list, tuple)) else [out]
    sum((o * _nchw(d)).sum() for o, d in zip(out, douts)).backward()
    got = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    got.update({f"input.{i}": _nhwc(t.grad) for i, t in enumerate(ts)})
    return got, want


def test_resnet34_encoder_matches_jax_eval_and_train():
    """The five outputs in eval mode; in train mode the outputs and every
    updated BatchNorm running statistic."""
    x = _rn(0, 1, 64, 64, 3)
    jm = JResNet34Encoder()
    v = _init(jm, x)
    pairs = resnet34_encoder_pairs(fpath=())
    tm = load_torch(ResNet34Encoder(), v, pairs)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert [tuple(g.shape) for g in got] == [(1, 64, 32, 32), (1, 64, 16, 16),
                                             (1, 128, 8, 8), (1, 256, 4, 4), (1, 512, 2, 2)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(_nhwc(g), np.asarray(w), 5e-4, f"eval output {i}")

    want, upd = jax.jit(lambda v_, x_: jm.apply(v_, x_, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = tm.train()(_nchw(x))
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(_nhwc(g), np.asarray(w), 5e-4, f"train output {i}")
    want_sd = jax_to_torch_state_dict({"params": v["params"], **jax.device_get(upd)}, pairs)
    sd = tm.state_dict()
    stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 36  # the stem, 16 blocks x 2, 3 shortcuts
    for k in stats:
        assert_close(sd[k].numpy(), want_sd[k].numpy(), 1e-4, k)


def test_selayer_matches_jax():
    _check_block(*_GRAD_CASES["SELayer"](), "SELayer")


def test_hppf_matches_jax():
    """HPPF(192) on a 16x16 map: its DSConv(192 -> 12) runs GroupNorm of 3
    groups on the 4x4 max pool; both pooled branches flatten channel-major."""
    inputs = [_rn(2, 1, 16, 16, 64), _rn(3, 1, 8, 8, 64), _rn(4, 1, 4, 4, 64)]
    _check_block(jum.HPPF(192), tum.HPPF(192), inputs, sub_pairs(("HPPF_0",), "hpp.", PAIRS),
                 "HPPF")


def test_rcg_matches_jax():
    """UM_Net's RCG: DSConv fuse, ConvTranspose, a single-direction Mamba over
    the 16x16 tokens, the strided conv back and the gate."""
    inputs = [_rn(5, 1, 8, 8, 1), _rn(6, 1, 20, 20, 64), _rn(7, 1, 8, 8, 64)]
    _check_block(jum.RCG(), tum.RCG(), inputs, sub_pairs(("RCG_0",), "rcg4.", PAIRS), "RCG")


@pytest.mark.parametrize("block,fprefix,tprefix,cin,cout", [
    ("DecoderBlock", ("DecoderBlock_1",), "decoder4.", 128, 64),
    ("SideoutBlock", ("SideoutBlock_0",), "side5.", 64, 1),
])
def test_decoder_and_sideout_blocks_match_jax(block, fprefix, tprefix, cin, cout):
    _check_block(getattr(jum, block)(cin, cout), getattr(tum, block)(cin, cout),
                 [_rn(cin, 2, 6, 6, cin)], sub_pairs(fprefix, tprefix, PAIRS), block)


def _nonlocal_pairs(fp, tk):
    p = []
    for i, name in enumerate(("g", "phi", "theta", "W.0")):
        p += dsconv_pairs((*fp, f"DSConv_{i}"), f"{tk}{name}")
    return p + bn_pairs((*fp, "BatchNorm_0"), f"{tk}W.1")


def test_nonlocal_block_matches_jax():
    _check_block(jum.NonLocalBlock(8), tum.NonLocalBlock(8), [_rn(8, 2, 6, 8, 8)],
                 _nonlocal_pairs((), ""), "NonLocalBlock")


@pytest.mark.parametrize("cascade", [False, True])
def test_algm_matches_jax(cascade):
    """ALGM(32, pool_size (1, 2, 3), two outputs of 64): the flax modules
    numbered in call order onto the port's conv_in, non_local, dilated.i,
    outs.j (SELayer, conv, BN) and, with `cascade`, guides.j."""
    x = _rn(9, 1, 8, 8, 32)
    p = conv_pairs(("Conv_0",), "conv_in.0") + bn_pairs(("BatchNorm_0",), "conv_in.1")
    p += _nonlocal_pairs(("NonLocalBlock_0",), "non_local.")
    for i in range(3):
        p += conv_pairs((f"Conv_{i + 1}",), f"dilated.{i}.0")
        p += bn_pairs((f"BatchNorm_{i + 1}",), f"dilated.{i}.1")
    n = 4
    for j in range(2):
        p += dense_pairs((f"SELayer_{j}", "Dense_0"), f"outs.{j}.0.fc.0", bias=False)
        p += dense_pairs((f"SELayer_{j}", "Dense_1"), f"outs.{j}.0.fc.2", bias=False)
        p += conv_pairs((f"Conv_{n}",), f"outs.{j}.1")
        p += bn_pairs((f"BatchNorm_{n}",), f"outs.{j}.2")
        n += 1
        if cascade:
            p += conv_pairs((f"Conv_{n}",), f"guides.{j}.0")
            p += bn_pairs((f"BatchNorm_{n}",), f"guides.{j}.1")
            n += 1
    jm = jum.ALGM(32, (1, 2, 3), (64, 64), cascade=cascade)
    tm = tum.ALGM(32, (1, 2, 3), (64, 64), cascade=cascade)
    ys = [_rn(10, 1, 4, 4, 64), _rn(11, 1, 4, 4, 64)]
    v = _init(jm, x, ys)
    want = jax.jit(jm.apply)(v, jnp.asarray(x), [jnp.asarray(y) for y in ys])
    load_torch(tm, v, p)
    with torch.no_grad():
        got = tm(_nchw(x), [_nchw(y) for y in ys])
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(_nhwc(g), np.asarray(w), 1e-4, f"ALGM output {i}")


_SE_PAIRS = dense_pairs(("Dense_0",), "fc.0", bias=False) + dense_pairs(("Dense_1",), "fc.2",
                                                                        bias=False)
# name -> () -> (JAX module, port module, NHWC inputs, pairs): the blocks of
# the tests above at their sizes
_GRAD_CASES = {
    "SELayer": lambda: (jum.SELayer(32), tum.SELayer(32), [_rn(1, 2, 5, 6, 32)], _SE_PAIRS),
    "HPPF": lambda: (jum.HPPF(192), tum.HPPF(192),
                     [_rn(2, 1, 16, 16, 64), _rn(3, 1, 8, 8, 64), _rn(4, 1, 4, 4, 64)],
                     sub_pairs(("HPPF_0",), "hpp.", PAIRS)),
    "RCG": lambda: (jum.RCG(), tum.RCG(),
                    [_rn(5, 1, 8, 8, 1), _rn(6, 1, 20, 20, 64), _rn(7, 1, 8, 8, 64)],
                    sub_pairs(("RCG_0",), "rcg4.", PAIRS)),
    "DecoderBlock": lambda: (jum.DecoderBlock(128, 64), tum.DecoderBlock(128, 64),
                             [_rn(128, 2, 6, 6, 128)],
                             sub_pairs(("DecoderBlock_1",), "decoder4.", PAIRS)),
    "SideoutBlock": lambda: (jum.SideoutBlock(64, 1), tum.SideoutBlock(64, 1),
                             [_rn(64, 2, 6, 6, 64)], sub_pairs(("SideoutBlock_0",), "side5.", PAIRS)),
    "NonLocalBlock": lambda: (jum.NonLocalBlock(8), tum.NonLocalBlock(8), [_rn(8, 2, 6, 8, 8)],
                              _nonlocal_pairs((), "")),
    "ResNet34Encoder": lambda: (JResNet34Encoder(), ResNet34Encoder(), [_rn(0, 1, 64, 64, 3)],
                                resnet34_encoder_pairs(fpath=())),
}


# gradients that are zero in exact arithmetic: phi's GroupNorm bias shifts
# every key of the non-local attention alike, which the softmax over the keys
# removes
_EXACT_ZERO = {"NonLocalBlock": {"phi.gn.bias"}}


@pytest.mark.parametrize("name", list(_GRAD_CASES))
def test_block_gradients_match_jax(name):
    """Every parameter's and input's gradient of sum(out * dout) in eval mode,
    each held to its own tensor: max |port - jax| <= 1e-4 * max |jax| of that
    tensor (largest reading 5.5e-6, NonLocalBlock's W.0.offset_conv.bias), so
    that a zeroed or negated gradient fails however small the tensor (RCG's
    Mamba dt_proj weights are at 1e-7 here). A gradient that is zero in exact
    arithmetic is held to zero against the block's largest gradient."""
    got, want = _block_grads(*_GRAD_CASES[name]())
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if k in _EXACT_ZERO.get(name, ()):
            assert max(np.abs(got[k]).max(), np.abs(w).max()) <= 1e-4 * top, k
        else:
            err = np.abs(got[k].astype(np.float64) - w).max()
            assert err <= 1e-4 * np.abs(w).max(), (k, err, np.abs(w).max())


def test_um_net_eval_matches_jax():
    """The whole UM_Net in eval mode at 1x3x64x64 through `um_net_pairs`,
    built by `give_model`."""
    x = _rn(12, 1, 3, 64, 64)
    jm = jum.UM_Net()
    variables = randomize_batch_stats(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)),
                                      np.random.default_rng(1))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    model = load_torch(give_model("UM_Net", device="cpu"), variables, PAIRS)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (1, 1, 64, 64)
    assert_close(got.numpy(), want, 5e-4, "UM_Net logits")


def test_registry_counts_and_default_device():
    """give_model("UM_Net") lands on the card unless asked for the CPU (and
    raises here); the JAX constructor's keys pass through; the launch counts
    follow the modules: 3 fused scans (one per RCG Mamba) and 16 tap-convs
    (8 in the decoders, 4 in the side outputs, 3 in the RCGs, 1 in HPPF),
    or 3 grouped selective scans on the other route."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            give_model("UM_Net")
    m = give_model("UM_Net", device="cpu", num_classes=2, num_slices_list=(4, 4, 4, 4),
                   out_indices=(0, 1), heads=(1, 1, 1, 1))
    assert m.final[4].out_channels == 2 and m.num_slices_list == (4, 4, 4, 4)
    assert not m.training
    assert m.kernel_launches_per_forward() == {"mamba_fused_scan": 3, "tap_conv": 16}
    assert m.kernel_launches_per_train_step() == {"mamba_fused_scan": {"fwd": 3, "bwd": 3},
                                                  "tap_conv": {"fwd": 16, "bwd": 16}}
    per_block = {}
    for name, mod in m.named_modules():
        if isinstance(mod, tum.DSConv):
            per_block[name.split(".")[0]] = per_block.get(name.split(".")[0], 0) + 1
    assert per_block == {**{f"decoder{n}": 2 for n in (5, 4, 3, 2)},
                         **{f"side{n}": 1 for n in (5, 4, 3, 2)},
                         **{f"rcg{n}": 1 for n in (4, 3, 2)}, "hpp": 1}
    for mod in m.modules():
        if isinstance(mod, tum.Mamba):
            mod.scan_impl = "pallas"
    assert m.kernel_launches_per_forward() == {"selective_scan": 3, "tap_conv": 16}


def test_um_net_modules_never_import_jax():
    code = (
        "import sys\n"
        "import mm_unet_tpu_torch.models.um_net, mm_unet_tpu_torch.models.dsconv\n"
        "import mm_unet_tpu_torch.models.resnet, mm_unet_tpu_torch.ops.grid_sample\n"
        "import mm_unet_tpu_torch.train.losses\n"
        "from mm_unet_tpu_torch.models import give_model\n"
        "give_model('UM_Net', device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'mm_unet_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
