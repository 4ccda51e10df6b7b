"""The port's convolutional zoo models against the JAX package, on the CPU:
UNet (bilinear, and transposed-conv ups), ConvUNeXt and CFPNet, each at
2x3x64x64. For each: the eval logits, and one train-mode pass
(DiceFocal, backward) with its logits, loss, every parameter gradient and
every updated BatchNorm running statistic. Weights cross with
`jax_to_torch_state_dict` and each model's pair table.

The JAX variables come from `jax.eval_shape(model.init, ...)` with every
leaf drawn from a numpy seed (`jax_variables`: kernels at 1/sqrt(fan_in),
norm scales near 1, biases and embeddings small, BatchNorm running
statistics random), and the JAX model runs through `jax.jit`: eager flax
init takes up to a minute a model on the CPU.

The eval logits are compared in f32, as max |port - jax| <= LOGITS_TOL *
(1 + max |jax|) (sums in other orders). The train-mode pass runs in
float64 on both sides (JAX under `jax.enable_x64`, the port's modules in
f64), since the f32 random-init train step is ill-conditioned (see
`check_train`): its logits, loss and BatchNorm statistics in that form,
and every parameter gradient as max |port - jax| <= F64_TOL times the
larger of its own tensor's max |jax| and GRAD_FLOOR of the model's largest
gradient (a conv bias that feeds a train-mode BatchNorm has zero gradient
in exact arithmetic), all at F64_TOL. JAX builds its align-corners resize
matrices in f32 (`mm_unet_tpu/models/layers.py:21-38`), which moves its
f64 results ~1e-7 from exact ones: the largest readings, 2.3e-7 (ConvUNeXt's
gradients) and 4.1e-7 (f32 eval logits); models without that resize agree
to ~1e-13 in f64. These helpers serve the zoo's other two test files too.

ConvUNeXt's JAX module calls flax's `nn.gelu` with its default tanh form
(`convunext.py:30,33,92`); the reference's `nn.GELU()` is exact, and the
port is pinned to it. Its test runs the JAX module with the exact GELU
patched in for the test only, and states the distance of the unpatched
JAX logits.
"""

import math

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.models import cfpnet as jcfpnet
from mm_unet_tpu.models import convunext as jconvunext
from mm_unet_tpu.models import unet as junet
from mm_unet_tpu.train.losses import dice_focal_loss as jax_dice_focal_loss
from mm_unet_tpu.utils.torch_convert import cfpnet_pairs, convunext_pairs, unet_pairs
from mm_unet_tpu_torch.models.cfpnet import CFPNet
from mm_unet_tpu_torch.models.convunext import ConvUNeXt
from mm_unet_tpu_torch.models.unet import UNet
from mm_unet_tpu_torch.train.losses import dice_focal_loss
from mm_unet_tpu_torch.utils.convert import jax_grads_to_torch
from torch_port_harness import assert_close, load_torch

LOGITS_TOL = 1e-5
F64_TOL = 2e-6
GRAD_FLOOR = 1e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side of these tests runs on one thread: in the parallel
    test run, torch's thread pool contending with the other workers' made
    PVTv2's 0.2 s float64 pass take 10 s."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FlaxWith:
    """`flax.linen` with some of its names replaced: set as a JAX model
    module's `nn` (monkeypatch) to pin one of its functions for a test."""

    def __init__(self, **names):
        self.__dict__.update(names)

    def __getattr__(self, name):
        return getattr(flax.linen, name)


def exact_gelu(x, approximate=False):
    return flax.linen.gelu(x, approximate=False)


def inputs(seed: int, b: int = 2, size: int = 64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 3, size, size)).astype(np.float32)
    y = (rng.random((b, 1, size, size)) < 0.3).astype(np.float32)
    return x, y


def jax_variables(module, x, seed: int = 0) -> dict:
    """`module`'s variables at input x, every leaf drawn from a numpy seed."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        coll, name, shape = path[0].key, path[-1].key, s.shape
        if coll == "batch_stats":
            v = rng.uniform(0.5, 2.0, shape) if name == "var" else rng.normal(0.0, 0.3, shape)
        elif name == "kernel":
            fan_in = shape[0] if len(shape) == 3 and shape[0] == math.prod(shape[1:]) else \
                math.prod(shape[:-1])
            v = rng.standard_normal(shape) / math.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "alpha":
            v = 0.25 + 0.05 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def check_eval(jm, tm, variables, pairs, x, tol=LOGITS_TOL, what=""):
    """Port eval logits against JAX's; returns JAX's."""
    want = np.asarray(jax.jit(lambda v, x_: jm.apply(v, x_))(variables, jnp.asarray(x)))
    load_torch(tm, variables, pairs)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert_close(got, want, tol, f"{what} eval logits")
    return want


def grad_errors(got: dict, want: dict, tol=F64_TOL, floor=GRAD_FLOOR) -> list:
    """The tensors out of tolerance, as (name, max abs err, scale): each
    held to tol times the larger of its own max |want| and `floor` of the
    largest |want| of all."""
    top = max(float(np.abs(w).max()) for w in want.values())
    bad = []
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (name, g.shape, w.shape)
        err = float(np.abs(g.astype(np.float64) - w).max())
        scale = max(float(np.abs(w).max()), floor * top)
        if not err <= tol * scale:
            bad.append((name, err, scale))
    return bad


def check_train(jm, tm, variables, pairs, x, y, tol=F64_TOL, floor=GRAD_FLOOR, what="",
                prepare=None):
    """One train-mode pass of both, in float64: logits, DiceFocal loss,
    every parameter gradient and every updated BatchNorm running
    statistic. `prepare(tm)` runs after the port's model is put in train
    mode. (In f32 the random-init train step is ill-conditioned: at
    UNet's 2x3x64x64, the JAX step's own f32 gradients lie up to 1.6e-2 of
    their tensor's largest from its f64 ones, the port's 6.4e-3.)"""
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(params, rest_, x_, y_):
        out, upd = jm.apply({"params": params, **rest_}, x_, train=True, mutable=["batch_stats"])
        return jax_dice_focal_loss(out, y_), (out, upd)

    with jax.enable_x64():
        f64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     (variables["params"], rest, x, y))
        (jloss, (jout, upd)), jgrads = jax.device_get(
            jax.jit(jax.value_and_grad(loss, has_aux=True))(*f64))
    load_torch(tm, variables, pairs).double().train()
    if prepare is not None:
        prepare(tm)
    out = tm(torch.from_numpy(x).double())
    total = dice_focal_loss(out, torch.from_numpy(y).double())
    total.backward()
    assert_close(out.detach().numpy(), np.asarray(jout), tol, f"{what} train logits")
    assert abs(total.item() - float(jloss)) <= tol, what
    params = dict(tm.named_parameters())
    want = {k: v.numpy() for k, v in jax_grads_to_torch(jgrads, pairs, like=params).items()}
    assert set(want) == set(params), what
    got = {k: p.grad.numpy() for k, p in params.items()}
    bad = grad_errors(got, want, tol, floor)
    assert not bad, f"{what}: {len(bad)} of {len(want)} gradients out of tolerance: {bad[:4]}"
    sd = tm.state_dict()
    for fp, tk, _ in pairs:
        if fp[-1] in ("mean", "var"):
            node = upd["batch_stats"]
            for key in fp:
                node = node[key]
            assert_close(sd[tk].numpy(), np.asarray(node), tol, f"{what} {tk}")
    return want


def test_unet_matches_jax():
    """Eval at 2x3x64x64; the float64 train pass at 2x3x32x32 (XLA's
    float64 convolutions on the CPU take 6.6 s at 64²; 32² still leaves a
    2x2 map with BatchNorm over 8 values a channel at the bottom)."""
    x, _ = inputs(0)
    jm = junet.UNet(num_classes=1)
    check_eval(jm, UNet(), jax_variables(jm, x, seed=1), unet_pairs(), x, what="UNet")
    x, y = inputs(6, size=32)
    check_train(jm, UNet(), jax_variables(jm, x, seed=7), unet_pairs(), x, y, what="UNet")


def test_unet_transposed_ups_match_jax():
    """bilinear=False (the root model.py's mini Unet): eval logits."""
    x, _ = inputs(1)
    jm = junet.UNet(num_classes=2, bilinear=False)
    v = jax_variables(jm, x, seed=2)
    check_eval(jm, UNet(num_classes=2, bilinear=False), v, unet_pairs(False), x, what="UNet")


def test_convunext_matches_jax(monkeypatch):
    """base_c 16. The JAX module runs with the exact GELU patched in; its
    unpatched (tanh) logits lie 4.7e-4 of their largest from the exact
    ones here, against 4e-7 between the port and the patched JAX."""
    x, y = inputs(2)
    jm = jconvunext.ConvUNeXt(num_classes=1, base_c=16)
    v = jax_variables(jm, x, seed=3)
    pairs = convunext_pairs()
    tanh = np.asarray(jax.jit(lambda v_, x_: jm.apply(v_, x_))(v, jnp.asarray(x)))
    monkeypatch.setattr(jconvunext, "nn", FlaxWith(gelu=exact_gelu))
    exact = check_eval(jm, ConvUNeXt(base_c=16), v, pairs, x, what="ConvUNeXt")
    dist = np.abs(tanh - exact).max() / np.abs(exact).max()
    assert 1e-4 < dist < 2e-3, dist
    check_train(jm, ConvUNeXt(base_c=16), v, pairs, x, y, what="ConvUNeXt")


def test_cfpnet_matches_jax():
    """block_2 = 2 (dilation 4) of the default 6 (4, 4, 8, 8, 16, 16): the
    same module four more times would triple the JAX compile."""
    x, y = inputs(4)
    jm = jcfpnet.CFPNet(classes=1, block_2=2)
    v = jax_variables(jm, x, seed=5)
    pairs = cfpnet_pairs(block_2=2)
    check_eval(jm, CFPNet(block_2=2), v, pairs, x, what="CFPNet")
    check_train(jm, CFPNet(block_2=2), v, pairs, x, y, what="CFPNet")
