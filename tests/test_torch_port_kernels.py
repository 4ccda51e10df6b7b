"""The port's two kernel modules against the JAX package.

On the CPU the port's `mamba_fused_scan` and `tap_conv` run their plain
PyTorch versions; they are held to the JAX kernels run in Pallas interpret
mode (as tests/test_mamba_fused.py and tests/test_tap_conv.py run them), on
the same numpy-seeded inputs. The CUDA kernels themselves are held to the
plain versions by the `cuda`-marked tests of tests/test_torch_port_cuda.py,
which run only on a GPU.

Tolerances, as max |port - jax| <= tol * (1 + max |jax|):
- f32: 1e-4 — the TPU kernel's chunked window scan and the plain
  token-by-token scan sum in different orders;
- bf16: 1.6e-2 (two bf16 ulps) — both round at the same points (weights,
  conv output, x_dbl's dt rows, gated output; tap values, output), but an
  f32 sum that lands on a rounding boundary may round the other way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.ops.mamba_fused import mamba_fused_scan as jax_mamba_fused_scan
from mm_unet_tpu.ops.tap_conv import tap_conv as jax_tap_conv
from mm_unet_tpu_torch.ops.causal_conv1d import causal_conv1d
from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan, mamba_fused_scan_ref
from mm_unet_tpu_torch.ops.selective_scan import selective_scan_ref
from mm_unet_tpu_torch.ops.tap_conv import tap_conv, tap_conv_ref
from torch_port_harness import assert_close

TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}


def _mamba_inputs(D, L, G, W, bias, seed=0, B=2, N=16, R=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [
        np.concatenate([f(B, G, D, L) * 0.5, f(B, G, D, L)], axis=2),
        f(G, D, W) * 0.4, f(G, D) * 0.1 if bias else None,
        f(G, R + 2 * N, D) * D ** -0.5, f(G, D, R) * 0.3, f(G, D) * 0.1,
        -np.exp(f(G, D, N) * 0.5), f(G, D),
    ]


def _both(args, dtype):
    jx = [None if a is None else jnp.asarray(a) for a in args]
    th = [None if a is None else torch.from_numpy(a) for a in args]
    jx[0] = jx[0].astype(jnp.dtype(dtype))
    th[0] = th[0].to(getattr(torch, dtype))
    return jx, th


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("W", [2, 3, 4])
def test_mamba_fused_scan_matches_jax(W, reverse, bias):
    args = _mamba_inputs(D=8, L=40, G=1, W=W, bias=bias, seed=W)
    jx, th = _both(args, "float32")
    want = np.asarray(jax_mamba_fused_scan(*jx, reverse=reverse))
    got = mamba_fused_scan(*th, reverse=reverse)
    assert got.shape == (2, 1, 8, 40) and got.dtype == torch.float32
    assert_close(got.numpy(), want, TOL["float32"], f"W={W} reverse={reverse}")


@pytest.mark.parametrize("reverse", [False, True])
def test_mamba_fused_scan_groups_and_bf16_match_jax(reverse):
    args = _mamba_inputs(D=6, L=33, G=2, W=4, bias=True, seed=7)
    for dtype in ("float32", "bfloat16"):
        jx, th = _both(args, dtype)
        want = jax_mamba_fused_scan(*jx, reverse=reverse)
        got = mamba_fused_scan(*th, reverse=reverse)
        assert got.dtype == getattr(torch, dtype)
        assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), TOL[dtype],
                     f"{dtype} reverse={reverse}")


def test_mamba_fused_scan_reverse_is_flipped_forward():
    """Reverse = forward on the flipped sequence, flipped back."""
    args = [None if a is None else torch.from_numpy(a)
            for a in _mamba_inputs(D=4, L=17, G=1, W=4, bias=True, seed=3)]
    rev = mamba_fused_scan_ref(*args, reverse=True)
    flipped = [args[0].flip(-1)] + args[1:]
    fwd = mamba_fused_scan_ref(*flipped, reverse=False).flip(-1)
    torch.testing.assert_close(rev, fwd, rtol=1e-5, atol=1e-6)


def test_causal_conv1d_reverse_is_anticausal():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 3, 9)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    rev = causal_conv1d(x, w, reverse=True)
    want = causal_conv1d(x.flip(-1), w).flip(-1)
    torch.testing.assert_close(rev, want)
    # a sequence shorter than the filter: the far taps read only padding
    short = causal_conv1d(x[..., :2], w)
    torch.testing.assert_close(short, causal_conv1d(x, w)[..., :2])


def test_selective_scan_ref_last_state_and_constant_bc():
    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    u, dt = f(2, 3, 5), f(2, 3, 5).abs() * 0.3
    A = -f(3, 4).exp()
    Bc, C = f(3, 4), f(2, 4, 5)
    y, last = selective_scan_ref(u, dt, A, Bc, C, return_last_state=True)
    # explicit recurrence
    h = torch.zeros(2, 3, 4)
    ys = []
    for t in range(5):
        h = torch.exp(dt[..., t, None] * A) * h + dt[..., t, None] * Bc * u[..., t, None]
        ys.append((h * C[:, None, :, t]).sum(-1))
    torch.testing.assert_close(y, torch.stack(ys, -1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(last, h, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k,h", [(1, 4), (3, 5), (5, 6), (9, 3)])
def test_geometry_matches_jax(k, h):
    """Offset accumulation from the kernel centre and the serpentine
    flatten (odd and even H) with its inverse."""
    from mm_unet_tpu.ops import geometry as jg
    from mm_unet_tpu_torch.ops import geometry as tg

    y = np.random.default_rng(k).standard_normal((2, h, 7, k)).astype(np.float32)
    got = tg.accumulate_offsets_from_center_last(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, jg.accumulate_offsets_from_center_last(jnp.asarray(y)),
                               rtol=1e-6, atol=1e-6)
    tokens = tg.two_row_flatten_tokens(torch.from_numpy(y))
    np.testing.assert_array_equal(tokens.numpy(), jg.two_row_flatten_tokens(jnp.asarray(y)))
    np.testing.assert_array_equal(tg.inverse_two_row_flatten_tokens(tokens, h, 7).numpy(), y)


def _tap_inputs(B, H, W, C, F, K, seed=0):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B, H, W, C)).astype(np.float32)
    # row coordinates from 3 rows above the map to 3 below it: the clip
    y = rng.uniform(-3.0, H + 2.0, (B, H, W, K)).astype(np.float32)
    kernel = (rng.standard_normal((K, 1, C, F)) * (K * C) ** -0.5).astype(np.float32)
    bias = rng.standard_normal(F).astype(np.float32) * 0.1
    return feat, y, kernel, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [1, 3])
def test_tap_conv_matches_jax(K, dtype):
    feat, y, kernel, bias = _tap_inputs(2, 12, 16, 8, 6, K, seed=K)
    shifts = [j - K // 2 for j in range(K)]
    want = jax_tap_conv(jnp.asarray(feat).astype(jnp.dtype(dtype)), jnp.asarray(y),
                        jnp.asarray(kernel), jnp.asarray(bias), shifts)
    got = tap_conv(torch.from_numpy(feat).to(getattr(torch, dtype)), torch.from_numpy(y),
                   torch.from_numpy(kernel), torch.from_numpy(bias), shifts)
    assert got.shape == (2, 12, 16, 6) and got.dtype == getattr(torch, dtype)
    assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), TOL[dtype],
                 f"K={K} {dtype}")


def test_tap_conv_wide_shifts_and_single_row():
    """K=5 reaches two columns past each edge (clamped); H=1 has no row to
    interpolate towards (frac is 0)."""
    feat, y, kernel, bias = _tap_inputs(1, 1, 8, 4, 3, 5, seed=5)
    shifts = [-2, -1, 0, 1, 2]
    got = tap_conv(*(torch.from_numpy(a) for a in (feat, y, kernel, bias)), shifts)
    taps = [feat[:, :, np.clip(np.arange(8) + s, 0, 7)] for s in shifts]  # y clips to row 0
    want = sum(t @ kernel[j, 0] for j, t in enumerate(taps)) + bias
    assert_close(got.numpy(), want, 1e-5, "K=5, H=1")


def test_wrappers_raise_off_cpu_and_cuda():
    """On a device with no kernel the wrappers raise instead of falling back."""
    feat, y, kernel, bias = (torch.from_numpy(a).to("meta") for a in _tap_inputs(1, 4, 8, 2, 2, 1))
    with pytest.raises(ValueError, match="no kernel"):
        tap_conv(feat, y, kernel, bias, [0])
    args = [torch.from_numpy(a).to("meta") for a in _mamba_inputs(4, 8, 1, 4, True)]
    with pytest.raises(ValueError, match="no kernel"):
        mamba_fused_scan(*args)


@pytest.mark.parametrize("name", ["MM_Net", "dkDualNet"])
def test_chunk_lengths_split_into_backward_sub_chunks(name):
    """Every megakernel Mamba of the model gets a chunk of whole sub-chunks
    of the backward's pass C (which rebuilds the states of `_SUB_CHUNK`
    tokens at a time in registers), within the kernels' range."""
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.models.mamba import Mamba
    from mm_unet_tpu_torch.ops.mamba_fused import _SUB_CHUNK, _chunk_len

    model = give_model(name, device="cpu", generator=torch.Generator().manual_seed(0))
    dims = {(m.d_inner, m.dt_rank + 2 * m.d_state) for m in model.modules()
            if isinstance(m, Mamba) and m.use_mega}
    assert dims, "no megakernel Mamba"
    for D, E in sorted(dims):
        T = _chunk_len(D, E)
        assert 16 <= T <= 256 and T % _SUB_CHUNK == 0, (D, E, T)
