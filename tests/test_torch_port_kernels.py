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
@pytest.mark.parametrize("N", [8, 32])
def test_mamba_fused_scan_state_counts_match_jax(N, reverse):
    """The other state counts the CUDA kernels are built for that the JAX
    kernel takes (d_state a multiple of 8): 8 and 32."""
    args = _mamba_inputs(D=8, L=40, G=1, W=4, bias=True, seed=N + reverse, N=N)
    jx, th = _both(args, "float32")
    want = np.asarray(jax_mamba_fused_scan(*jx, reverse=reverse))
    got = mamba_fused_scan(*th, reverse=reverse)
    assert got.shape == (2, 1, 8, 40) and got.dtype == torch.float32
    assert_close(got.numpy(), want, TOL["float32"], f"N={N} reverse={reverse}")


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


# every megakernel Mamba width (d_inner) the port builds, by model: MM_Net's
# offset Mambas and RCG detours, dkDualNet's and HWAUNETR's stages, the
# Mamba LM at mamba-130m's and mamba-370m's widths
MEGA_WIDTHS = {"MM_Net": {2, 6, 128}, "dkDualNet": {96, 192, 384},
               "HWAUNETR": {96, 192, 384, 768}, "mamba-130m": {1536}, "mamba-370m": {2048}}


def _check_bwd_plan(D, E, N):
    """Kernel 2's plan for one width: every pass within the shared memory a
    block can take, at most 16 blocks a cluster covering the D channels
    with none empty, the forward's chunk of whole sub-chunks, and a chunk
    whole in one block exactly for D <= _BWD_CHANNELS."""
    from mm_unet_tpu_torch.ops.mamba_fused import (
        _BWD_CHANNELS, _SMEM_OPT_IN, _SUB_CHUNK, _bwd_plan, _chunk_len)

    plan = _bwd_plan(D, E, N)
    T, Dc, nb = plan["T"], plan["Dc"], plan["nb"]
    assert max(plan["bytes"].values()) <= _SMEM_OPT_IN, (D, plan)
    assert 1 <= nb <= 16 and Dc * nb >= D > (nb - 1) * Dc, (D, plan)
    assert T == _chunk_len(D, E) and T % _SUB_CHUNK == 0, (D, plan)
    assert (nb == 1) == (D <= _BWD_CHANNELS) and (nb > 1 or Dc == D), (D, plan)
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 256, (D, plan)
    return plan


def _check_fwd_plan(D, E, N):
    """Kernel 1's plan for one width: the forward's chunk length, every pass
    within the shared memory a block can take, the blocks covering the D
    channels with none empty, whole warps of at most 512 threads, and one
    block a chunk (the whole-chunk launch, as before the split) exactly
    where two blocks of the whole chunk's tile fit an SM."""
    from mm_unet_tpu_torch.ops.mamba_fused import (
        _FWD_CHANNELS, _SMEM_OPT_IN, _SMEM_TWO_PER_SM, _chunk_len, _fwd_plan, _tile_bytes)

    plan = _fwd_plan(D, E, N)
    T, Dc, nb = plan["T"], plan["Dc"], plan["nb"]
    assert T == _chunk_len(D, E), (D, plan)
    assert max(plan["bytes"].values()) <= _SMEM_OPT_IN, (D, plan)
    assert Dc * nb >= D > (nb - 1) * Dc, (D, plan)
    assert (nb == 1) == (_tile_bytes(D, E, T) <= _SMEM_TWO_PER_SM), (D, plan)
    assert nb == 1 or Dc <= _FWD_CHANNELS, (D, plan)
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 512, (D, plan)
    return plan


@pytest.mark.parametrize("name", ["MM_Net", "dkDualNet", "HWAUNETR", "mamba-130m", "mamba-370m"])
def test_chunk_lengths_split_into_backward_sub_chunks(name):
    """Every megakernel Mamba of the model gets a chunk of whole sub-chunks
    of the forward's pass 3 and the backward's pass C (which keep
    `_SUB_CHUNK` tokens at a time in registers), within the kernels' range,
    and plans that fit (`_check_fwd_plan`, `_check_bwd_plan`). Every width
    of the zoo keeps the forward's whole-chunk launch (one block a chunk, at
    the same chunk length); the LMs' D 1536 and 2048 split. At MM_Net's D
    128, two pass-C blocks fit an SM's 228 KB of
    shared memory (and its registers: 256 threads at most 128 registers
    each, the kernel's launch bounds)."""
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.models.lm import MAMBA_130M, MAMBA_370M, give_lm
    from mm_unet_tpu_torch.models.mamba import Mamba
    from mm_unet_tpu_torch.ops.mamba_fused import _SUB_CHUNK, _chunk_len

    lms = {"mamba-130m": MAMBA_130M, "mamba-370m": MAMBA_370M}
    if name in lms:
        model = give_lm(dict(lms[name], n_layer=1), device="cpu")
    else:
        model = give_model(name, device="cpu", generator=torch.Generator().manual_seed(0))
    dims = {(m.d_inner, m.dt_rank + 2 * m.d_state, m.d_state) for m in model.modules()
            if isinstance(m, Mamba) and m.use_mega}
    assert {D for D, _, _ in dims} == MEGA_WIDTHS[name]
    for D, E, N in sorted(dims):
        T = _chunk_len(D, E)
        assert 16 <= T <= 256 and T % _SUB_CHUNK == 0, (D, E, T)
        fwd = _check_fwd_plan(D, E, N)
        assert (fwd["nb"] == 1) == (name not in lms), (D, fwd)
        plan = _check_bwd_plan(D, E, N)
        if D == 128:
            assert 2 * (plan["bytes"]["c"] + 1024) <= 228 * 1024 and plan["threads"] == 256


def test_forward_plan_at_the_lm_widths_and_past_the_whole_chunk_tile():
    """mamba-370m's d_inner 2048 (dt_rank 64, E 96) would need 283,968 B of
    shared memory for a whole chunk at T 16, past the opt-in, and
    mamba-130m's D 1536 (E 80) 214,336 B, one block an SM: the forward
    splits them into 8 and 6 blocks of 256 channels behind the x_dbl pass,
    each within two blocks' share of an SM. The last whole-chunk width at
    E 80 is D 810; one channel more splits. A forced block size `Dc`
    splits any width, and Dc = D keeps the chunk whole."""
    from mm_unet_tpu_torch.ops.mamba_fused import _SMEM_TWO_PER_SM, _fwd_plan

    plan = _check_fwd_plan(2048, 96, 16)
    assert (plan["T"], plan["Dc"], plan["nb"], plan["threads"]) == (16, 256, 8, 512)
    assert plan["bytes"] == {"chunk": (2 * 256 + 96) * 17 * 4, "x": (256 + 96) * 17 * 4}
    plan = _check_fwd_plan(1536, 80, 16)
    assert (plan["T"], plan["Dc"], plan["nb"]) == (16, 256, 6)
    assert max(plan["bytes"].values()) <= _SMEM_TWO_PER_SM
    assert _check_fwd_plan(810, 80, 16)["nb"] == 1
    assert _check_fwd_plan(811, 80, 16)["nb"] == 4
    forced = _fwd_plan(128, 36, 16, Dc=48)
    assert (forced["T"], forced["Dc"], forced["nb"]) == (64, 48, 3)
    whole = _fwd_plan(1536, 80, 16, Dc=1536)
    assert (whole["nb"], whole["bytes"]) == (1, {"chunk": 214336, "x": 0})


@pytest.mark.parametrize("D,E", [(2048, 96), (3072, 128), (4096, 160), (5120, 192), (5968, 80)])
def test_forward_plan_takes_every_width_the_backward_plan_takes(D, E):
    """mamba-370m, -790m, -1.4b and -2.8b's widths (D = 2 d_model, E =
    d_model / 16 + 32) and the backward's widest at E 80: both plans take
    each, the forward in blocks of at most 256 channels."""
    _check_bwd_plan(D, E, 16)
    assert _check_fwd_plan(D, E, 16)["nb"] == -(-D // 256)


def test_forward_plan_limit_is_its_x_dbl_rows():
    """The forward's only limit: a split block holds the E x_dbl rows and at
    least one channel's two rows, (2 + E) 17 floats at T 16, so E 3,416
    fits (in blocks of one channel) and E 3,417 raises with the shape."""
    from mm_unet_tpu_torch.ops.mamba_fused import _fwd_plan

    assert _check_fwd_plan(3400, 3416, 16)["Dc"] == 1
    with pytest.raises(ValueError, match=r"D 3400 \(E 3417, N 16\)"):
        _fwd_plan(3400, 3417, 16)


def test_backward_plan_past_the_lm_width_and_its_limit():
    """Kernel 2 takes D 2048 (mamba-370m's d_inner, E 96) in a cluster of 8
    blocks of 256; its limit is the widest block a cluster of 8 can take at
    the shortest chunk: at E 80 (mamba-130m's x_dbl rows), N 16 that is 8 x
    746 channels, and one more raises with the shape."""
    from mm_unet_tpu_torch.ops.mamba_fused import _bwd_plan

    plan = _check_bwd_plan(2048, 96, 16)
    assert (plan["T"], plan["Dc"], plan["nb"]) == (16, 256, 8)
    assert _check_bwd_plan(5968, 80, 16)["Dc"] == 746
    with pytest.raises(ValueError, match=r"D 5969 \(E 80, N 16\).*D <= 5968"):
        _bwd_plan(5969, 80, 16)
