"""The port's deformable sampling pieces against the JAX package, on the
CPU: bilinear grid sampling in both layouts, DSConv in both morphs and
MMConv morph 1 (outputs and the gradients of the input and of every
parameter), and the tap-conv's row lerp where DSConv's morph 0 meets it
(the last row, maps of one and two rows, integer rows).

Weights move across with `jax_to_torch_state_dict` and the reference's pair
tables (`dsconv_pairs`, `mmconv_pairs(morph=1)`), gradients with
`jax_grads_to_torch`. JAX's DSConv samples morph 0 with its 2-hot matmul
for maps of up to 256 rows and with its row gather above; the port runs
the tap-conv's plain version for both. f32 throughout. Tolerances, as
max |port - jax| <= tol * (1 + max |jax|):
- grid sample: 1e-6 (the same four products per output);
- DSConv and MMConv outputs and gradients: 1e-4 (summation orders of the
  convolutions, then GroupNorm's rescaling);
- the row lerp: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.models.dsconv import DSConv as JDSConv
from mm_unet_tpu.models.layers import deform_sample_rows as jax_deform_rows
from mm_unet_tpu.models.layers import deform_sample_rows_matmul as jax_deform_matmul
from mm_unet_tpu.models.layers import grid_sample_bilinear_nhwc as jax_grid_sample_nhwc
from mm_unet_tpu.models.mm_unet import MMConv as JMMConv
from mm_unet_tpu.ops.grid_sample import grid_sample_bilinear as jax_grid_sample
from mm_unet_tpu.utils.torch_convert import dsconv_pairs, mmconv_pairs
from mm_unet_tpu_torch.models.dsconv import DSConv
from mm_unet_tpu_torch.models.layers import grid_sample_bilinear_nhwc
from mm_unet_tpu_torch.models.mm_unet import MMConv
from mm_unet_tpu_torch.ops.grid_sample import grid_sample_bilinear
from mm_unet_tpu_torch.ops.tap_conv import tap_conv
from mm_unet_tpu_torch.utils.convert import jax_grads_to_torch
from torch_port_harness import assert_close, load_torch, to_numpy

TOL = 1e-4


def _grid(rng, b, hg, wg):
    """Grid values inside [-1, 1], past both edges, and exactly on -1, 0, 1."""
    g = rng.uniform(-1.3, 1.3, (b, hg, wg, 2)).astype(np.float32)
    g[:, 0, :3] = [[-1.0, -1.0], [1.0, 1.0], [0.0, 1.0]]
    g[:, -1, -2:] = [[1.0, -1.0], [-1.0, 0.0]]
    return g


def test_grid_sample_matches_jax_and_the_stored_torch_output():
    from pathlib import Path

    golden = np.load(Path(__file__).parent / "fixtures" / "torch_golden.npz")
    got = grid_sample_bilinear(torch.from_numpy(golden["gs_feat"]),
                               torch.from_numpy(golden["gs_grid"]))
    assert_close(got.numpy(), golden["gs_want"], 1e-6, "stored torch output")
    rng = np.random.default_rng(0)
    for b, c, h, w, hg, wg in ((2, 5, 7, 9, 6, 11), (1, 3, 1, 4, 3, 5), (2, 2, 6, 1, 4, 4)):
        feat = rng.standard_normal((b, c, h, w)).astype(np.float32)
        grid = _grid(rng, b, hg, wg)
        want = np.asarray(jax_grid_sample(jnp.asarray(feat), jnp.asarray(grid)))
        got = grid_sample_bilinear(torch.from_numpy(feat), torch.from_numpy(grid))
        assert got.shape == (b, c, hg, wg)
        assert_close(got.numpy(), want, 1e-6, f"NCHW {feat.shape}")
        nhwc = np.ascontiguousarray(feat.transpose(0, 2, 3, 1))
        want = np.asarray(jax_grid_sample_nhwc(jnp.asarray(nhwc), jnp.asarray(grid)))
        got = grid_sample_bilinear_nhwc(torch.from_numpy(nhwc), torch.from_numpy(grid))
        assert got.shape == (b, hg, wg, c)
        assert_close(got.numpy(), want, 1e-6, f"NHWC {nhwc.shape}")


def _root(pairs, prefix):
    """Pair entries re-rooted at a module: torch keys lose `prefix`."""
    return [(fp, tk[len(prefix):], kind) for fp, tk, kind in pairs]


def _both(jm, tm, x, pairs, seed):
    """(JAX output, port output, JAX gradients, port gradients) of sum(out *
    w) for a random w, by input ("x") and by torch parameter name."""
    v = to_numpy(jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x)))
    load_torch(tm, v, pairs)
    w = np.random.default_rng(seed + 100).standard_normal(
        jax.eval_shape(jm.apply, v, jnp.asarray(x)).shape).astype(np.float32)

    def jloss(params, xj):
        out = jm.apply({"params": params}, xj)
        return jnp.sum(out * w), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        v["params"], jnp.asarray(x))
    want = np.asarray(want)
    want_grads = jax_grads_to_torch(to_numpy(gp), pairs)
    want_grads["x"] = torch.from_numpy(np.asarray(gx).transpose(0, 3, 1, 2).copy())
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_(True)
    out = tm(xt)
    (out * torch.from_numpy(np.ascontiguousarray(w.transpose(0, 3, 1, 2)))).sum().backward()
    got_grads = {k: p.grad for k, p in tm.named_parameters()}
    got_grads["x"] = xt.grad
    assert set(got_grads) == set(want_grads)
    return want, out.detach().permute(0, 2, 3, 1).numpy(), want_grads, got_grads


@pytest.mark.parametrize("morph,k,hw,cin,cout", [
    (0, 3, (12, 12), 3, 8), (0, 9, (12, 12), 3, 8), (1, 3, (12, 12), 3, 8),
    (1, 9, (12, 12), 3, 8),
    (0, 9, (260, 3), 2, 4),  # taller than 256 rows: JAX's row-gather branch
])
def test_dsconv_matches_jax(morph, k, hw, cin, cout):
    x = np.random.default_rng(k + morph).standard_normal((2, *hw, cin)).astype(np.float32)
    jm = JDSConv(cout, kernel_size=k, morph=morph)
    tm = DSConv(cin, cout, k, morph=morph)
    want, got, want_g, got_g = _both(jm, tm, x, dsconv_pairs((), "", morph), seed=k)
    assert got.shape == want.shape == (2, *hw, cout)
    assert_close(got, want, TOL, f"DSConv morph {morph} k={k}")
    for name, g in want_g.items():
        assert_close(got_g[name].numpy(), g.numpy(), TOL, f"d{name}")


def test_mmconv_morph1_matches_jax():
    """MMConv morph 1 (f32): the output keeps the JAX module's (B, H*K, W//k,
    F), and every gradient matches."""
    k, cin, cout = 3, 4, 8
    x = np.random.default_rng(1).standard_normal((2, 8, 12, cin)).astype(np.float32)
    jm = JMMConv(out_channels=cout, kernel_size=k, morph=1, num_slices=4, dtype=None)
    tm = MMConv(cin, cout, k, num_slices=4, morph=1)
    pairs = _root(mmconv_pairs(("m",), "m", kernel_size=k, morph=1), "m.")
    pairs = [(fp[1:], tk, kind) for fp, tk, kind in pairs]
    want, got, want_g, got_g = _both(jm, tm, x, pairs, seed=3)
    assert got.shape == want.shape == (2, 8 * k, 12 // k, cout)
    assert_close(got, want, TOL, "MMConv morph 1")
    for name, g in want_g.items():
        assert_close(got_g[name].numpy(), g.numpy(), TOL, f"d{name}")


def _taps(feat, y, shifts):
    """The tap-conv's sampled taps themselves, (B, H*K, W, C) as the JAX
    samplers return them: kernel tap j projects onto output block j."""
    b, h, w, c = feat.shape
    k = len(shifts)
    kernel = torch.zeros(k, 1, c, k * c)
    for j in range(k):
        kernel[j, 0, :, j * c:(j + 1) * c] = torch.eye(c)
    out = tap_conv(feat, y, kernel, torch.zeros(k * c), shifts)
    return out.reshape(b, h, w, k, c).permute(0, 1, 3, 2, 4).reshape(b, h * k, w, c)


SHIFTS = [-1, 0, 1]


@pytest.mark.parametrize("h", [1, 2, 5])
def test_tap_conv_row_lerp_values_at_the_edges(h):
    """Morph 0's row lerp, lo = clip(floor(y), 0, H-2) and lo + 1 in the
    port, against both JAX samplers (the row gather, y1 = min(y0 + 1, H-1);
    the 2-hot hat max(0, 1 - |s - y|)) at y = H-1 exactly, at integers,
    past both edges and between rows, for maps of 1, 2 and 5 rows."""
    rng = np.random.default_rng(h)
    feat = rng.standard_normal((2, h, 6, 3)).astype(np.float32)
    ys = np.array([h - 1.0, 0.0, -0.7, h + 0.4, (h - 1) / 2 + 0.3, 1.0, h - 1.5])
    y = rng.choice(ys, (2, h, 6, 3)).astype(np.float32)
    got = _taps(torch.from_numpy(feat), torch.from_numpy(y), SHIFTS).numpy()
    for sampler in (jax_deform_rows, jax_deform_matmul):
        want = np.asarray(sampler(jnp.asarray(feat), jnp.asarray(y), SHIFTS))
        assert_close(got, want, 1e-6, sampler.__name__)


@pytest.mark.parametrize("h", [5, 9])
def test_tap_conv_row_lerp_gradient_at_integer_rows(h):
    """The gradient w.r.t. y at interior integer rows is the forward slope
    v[y+1] - v[y], as JAX's row gather (`deform_sample_rows`, the sampler of
    maps taller than 256 rows) has it. JAX's 2-hot hat gives the mean of the
    two one-sided slopes there (jnp.maximum and jnp.abs split ties), so the
    two JAX samplers differ at exact integers; DSConv's only integer rows
    are its centre taps, whose coordinates carry no gradient to any
    parameter."""
    rng = np.random.default_rng(h)
    feat = rng.standard_normal((2, h, 6, 3)).astype(np.float32)
    y = rng.integers(1, h - 1, (2, h, 6, 3)).astype(np.float32)
    dout = rng.standard_normal((2, h * 3, 6, 3)).astype(np.float32)
    want = jax.grad(lambda yy: jnp.sum(jax_deform_rows(jnp.asarray(feat), yy, SHIFTS) * dout))(
        jnp.asarray(y))
    yt = torch.from_numpy(y).requires_grad_(True)
    (_taps(torch.from_numpy(feat), yt, SHIFTS) * torch.from_numpy(dout)).sum().backward()
    assert_close(yt.grad.numpy(), np.asarray(want), 1e-6, "dy at integer rows")
