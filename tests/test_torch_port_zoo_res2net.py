"""The port's Res2Net-50 encoder and CFANet against the JAX package, on the
CPU, in the forms of `test_torch_port_zoo_conv.py` and
`test_torch_port_zoo_pvt.py`: the encoder's five maps in f32 at
2x3x64x64 (LOGITS_TOL) and, in float64 at 2x3x32x32, every parameter
gradient of sum(map * dout) over them for seeded douts in train mode
(F64_TOL; its BatchNorms normalise with the batch statistics); CFANet's
eval logits in f32 and one train-mode pass in float64 at 2x3x32x32, at
its published widths (batch 4 at 32² for the float64 pass).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mm_unet_tpu.models import cfanet as jcfanet
from mm_unet_tpu.models.resnet import Res2Net50Encoder as JRes2Net50Encoder
from mm_unet_tpu.utils.torch_convert import cfanet_pairs, res2net50_pairs
from mm_unet_tpu_torch.models.cfanet import CFANet
from mm_unet_tpu_torch.models.resnet import Res2Net50Encoder
from mm_unet_tpu_torch.utils.convert import jax_grads_to_torch
from test_torch_port_zoo_conv import (LOGITS_TOL, check_eval, check_train, grad_errors, inputs,
                                      jax_variables, one_torch_thread)  # noqa: F401
from torch_port_harness import assert_close, load_torch

RES2NET_PAIRS = res2net50_pairs((), "")


def test_res2net50_encoder_matches_jax():
    x, _ = inputs(50)
    jm = JRes2Net50Encoder()
    xh = x.transpose(0, 2, 3, 1)
    v = jax_variables(jm, xh, seed=51)
    want = jax.jit(lambda v_, x_: jm.apply(v_, x_))(v, jnp.asarray(xh))
    tm = load_torch(Res2Net50Encoder(), v, RES2NET_PAIRS)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert [tuple(g.shape[1:]) for g in got] == [(64, 16, 16), (256, 16, 16), (512, 8, 8),
                                                 (1024, 4, 4), (2048, 2, 2)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), LOGITS_TOL, f"map {i}")

    x, _ = inputs(52)
    xh = x.transpose(0, 2, 3, 1)
    shapes = jax.eval_shape(lambda v_, x_: jm.apply(v_, x_), v, jnp.asarray(xh))
    rng = np.random.default_rng(53)
    douts = [rng.standard_normal(s.shape) for s in shapes]
    rest = {"batch_stats": v["batch_stats"]}

    def f(params, x_):
        maps, _ = jm.apply({"params": params, **rest}, x_, train=True, mutable=["batch_stats"])
        return sum(jnp.vdot(m, jnp.asarray(d)) for m, d in zip(maps, douts))

    with jax.enable_x64():
        args = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), (v["params"], xh))
        jgrads = jax.device_get(jax.jit(jax.grad(f))(*args))
    tm.double().train()
    maps = tm(torch.from_numpy(x).double())
    sum((m.permute(0, 2, 3, 1) * torch.from_numpy(d)).sum() for m, d in zip(maps, douts)).backward()
    params = dict(tm.named_parameters())
    want_g = {k: t.numpy() for k, t in jax_grads_to_torch(jgrads, RES2NET_PAIRS,
                                                          like=params).items()}
    got_g = {k: p.grad.numpy() for k, p in params.items()}
    assert set(want_g) == set(got_g)
    bad = grad_errors(got_g, want_g)
    assert not bad, f"{len(bad)} of {len(want_g)} gradients out of tolerance: {bad[:4]}"


def align_corners_matrix(n: int, m: int) -> np.ndarray:
    """The (m, n) align-corners interpolation matrix in float64 (the JAX
    package builds it in f32, `layers.py:21-38`)."""
    if n == 1 or m == 1:
        w = np.zeros((m, n))
        w[:, 0] = 1.0
        return w
    pos = np.arange(m) * (n - 1) / (m - 1)
    lo = np.minimum(np.floor(pos).astype(int), n - 2)
    w = np.zeros((m, n))
    w[np.arange(m), lo] = 1.0 - (pos - lo)
    w[np.arange(m), lo + 1] = pos - lo
    return w


def resize_align_corners_f64(x, out_hw):
    """`layers.resize_bilinear_align_corners` with float64 matrices."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    mh = jnp.asarray(align_corners_matrix(x.shape[1], out_hw[0]), x.dtype)
    mw = jnp.asarray(align_corners_matrix(x.shape[2], out_hw[1]), x.dtype)
    return jnp.einsum("bhwc,ph,qw->bpqc", x, mh, mw)


def test_cfanet_matches_jax(monkeypatch):
    """The JAX model's seven align-corners resizes run with float64
    matrices, for the test only: its f32 ones moved the float64 pass's
    gradients by up to 7e-6 of their tensor at 2x3x64x64 (through 50
    train-mode BatchNorms), past F64_TOL, which the port meets against
    exact ones. Batch 4 at 32² keeps four values a channel in the 1x1
    layer4's BatchNorms."""
    monkeypatch.setattr(jcfanet, "resize_bilinear_align_corners", resize_align_corners_f64)
    x, y = inputs(54, b=4, size=32)
    jm = jcfanet.CFANet()
    v = jax_variables(jm, x, seed=55)
    check_eval(jm, CFANet(), v, cfanet_pairs(), x, what="CFANet")
    check_train(jm, CFANet(), v, cfanet_pairs(), x, y, what="CFANet")
