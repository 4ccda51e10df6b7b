"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test decides inside itself whether there is a device and
skips without one. The file imports no jax, so on a machine without JAX it
runs on its own:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

The shapes are small but cut the sequence into several chunks (so the chunk
combine of the scans runs) and take every tile shape of the tap-conv
kernels (F <= 16, <= 32 and wider) and the edges of their design
(`TAP_EDGES`); the selective scan takes every layout and flag it has. Tolerance, as max |kernel - plain| <= tol * (1 + max
|plain|): f32 2e-4 (summation order only), bf16 1.6e-2 (two bf16 ulps: an
f32 sum on a rounding boundary may round the other way).
"""

import numpy as np
import pytest
import torch

from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan, mamba_fused_scan_ref
from mm_unet_tpu_torch.ops.tap_conv import tap_conv, tap_conv_ref

TOL = {torch.float32: 2e-4, torch.bfloat16: 1.6e-2}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * (1.0 + want.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("D,R,N,L", [
    (6, 1, 16, 1000), (128, 4, 16, 700),  # several chunks
    (6, 1, 16, 100), (128, 4, 16, 50),    # one chunk
    (2, 1, 16, 1000),   # chunks of 128: L ragged against the chunk and the 16-token sub-chunk
    (96, 6, 16, 300),   # chunks of 64, dkDualNet's narrowest route-a width
    (384, 12, 16, 200),  # chunks of 16 = one sub-chunk, 12 rounds of (d, n) pairs
    (8, 1, 8, 500),     # four channels per warp
    (7, 1, 8, 500),     # a warp whose last group of 8 lanes has no channel
    (8, 1, 32, 500),    # one channel per warp
    (96, 6, 16, 37),    # one chunk, ragged
])
def test_mamba_fused_kernel_matches_plain(D, R, N, L, reverse, dtype):
    """Several chunks and a single chunk (no pass 1 and no combine); the
    edges of pass 3's layout: state counts of 8 and 32, widths 2 to 384,
    lanes past the last (channel, state) pair, tokens that end inside a
    16-token sub-chunk."""
    dev = _device()
    rng = np.random.default_rng(D + L + (N != 16) * N)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    W, B = 4, 2
    xz = torch.cat([f(B, 1, D, L) * 0.5, f(B, 1, D, L)], dim=2).to(dtype)
    args = (f(1, D, W) * 0.4, f(1, D) * 0.1, f(1, R + 2 * N, D) * D ** -0.5,
            f(1, D, R) * R ** -0.5, f(1, D) * 0.1 - 4.0, -torch.exp(f(1, D, N) * 0.5),
            torch.ones(1, D, device=dev))
    before = mamba_fused_scan.launches
    got = mamba_fused_scan(xz, *args, reverse=reverse)
    assert mamba_fused_scan.launches == before + 1
    assert got.shape == (B, 1, D, L) and got.dtype == dtype and got.is_cuda
    _close(got, mamba_fused_scan_ref(xz, *args, reverse=reverse), dtype)


# The tap-conv kernels' edges, as (H, W, C, F, K, rows): a map tall enough
# that the backward's dfeat strip takes dynamic shared memory past 48 KB
# (256 rows x 16 channels) with W not a multiple of the strip; rows far
# outside the map (all clipped) and rows exactly on integers (and on both
# edges); C = 20, not a multiple of the 16-byte loads' 8 bf16 channels; F =
# 16 and 512; K = 1; a single-row map. "near" rows are the pixel's own row
# plus 2 N(0, 1), past both edges.
TAP_EDGES = [
    (256, 37, 16, 16, 3, "near"),
    (20, 29, 20, 24, 3, "far"),
    (12, 13, 16, 512, 3, "integer"),
    (9, 11, 24, 16, 1, "integer"),
    (1, 19, 16, 16, 3, "near"),
]
# UM_Net's DSConvs: 9 taps, (C, F) of a side output (64 -> 16), the HPPF
# (192 -> 12: F not a multiple of 8), a decoder's second conv (16 -> 64: C
# not a multiple of 8) and RCG (128 -> 64)
TAP_UM_NET = [
    (16, 21, 64, 16, 9, "near"),
    (4, 4, 192, 12, 9, "near"),
    (12, 17, 16, 64, 9, "far"),
    (8, 8, 128, 64, 9, "integer"),
]


def _tap_rows(rng, dev, b, h, w, k, rows):
    base = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
    if rows == "far":
        sign = torch.from_numpy(rng.choice([-1.0, 1.0], (b, h, w, k)).astype(np.float32))
        return base + 40.0 * sign.to(dev)
    if rows == "integer":
        return torch.from_numpy(rng.integers(-2, h + 2, (b, h, w, k)).astype(np.float32)).to(dev)
    return base + 2.0 * torch.from_numpy(rng.standard_normal((b, h, w, k)).astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,F,K,rows", [(24, 24, 64, 64, 3, "near"), (16, 16, 32, 16, 3, "near"),
                                            (16, 16, 128, 64, 1, "near"), *TAP_EDGES,
                                            *TAP_UM_NET])
def test_tap_conv_kernel_matches_plain(H, W, C, F, K, rows, dtype):
    dev = _device()
    rng = np.random.default_rng(H * C + K + F)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    feat = f(2, H, W, C).to(dtype)
    y = _tap_rows(rng, dev, 2, H, W, K, rows)
    kernel, bias = f(K, 1, C, F) * (K * C) ** -0.5, f(F) * 0.1
    shifts = [j - K // 2 for j in range(K)]
    before = tap_conv.launches
    got = tap_conv(feat, y, kernel, bias, shifts)
    assert tap_conv.launches == before + 1
    assert got.shape == (2, H, W, F) and got.dtype == dtype and got.is_cuda
    _close(got, tap_conv_ref(feat, y, kernel, bias, shifts), dtype)


# Backward kernels against autograd of the plain versions on the card. The
# gradients of each input, as max |kernel - plain| <= tol * (1 + max |plain|):
# f32 5e-4 (sums over chunks, blocks and atomics in other orders), bf16 3e-2
# (the plain version rounds some gradients at its casts, the kernel where the
# TPU kernel does, and errors of a few bf16 ulps add up over the sums).
BWD_TOL = {torch.float32: 5e-4, torch.bfloat16: 3e-2}


def _grads(fn, inputs, dout):
    ins = [t.detach().clone().requires_grad_(True) if t is not None else None for t in inputs]
    out = fn(*ins)
    out.backward(dout)
    return [None if t is None else t.grad for t in ins]


def _close_grads(got, want, dtype, names):
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        err = (g.float() - w.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * (1.0 + w.float().abs().max().item()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("D,R,N,L", [
    (6, 1, 16, 1000), (128, 4, 16, 700),  # several chunks
    (6, 1, 16, 100), (128, 4, 16, 50),    # one chunk
    (2, 1, 16, 1000),   # chunks of 128: L ragged against the chunk and the 16-token sub-chunk
    (96, 6, 16, 300),   # chunks of 64, dkDualNet's narrowest route-a width
    (384, 12, 16, 200),  # chunks of 16 = one sub-chunk, 6 blocks of 64 channels, 4 rounds
    (8, 1, 8, 500),     # four channels per warp
    (8, 1, 32, 500),    # one channel per warp
    (96, 6, 16, 37),    # one chunk, ragged, 2 blocks of 48 channels
    (48, 3, 16, 300),   # one block of 48 channels, 3 rounds
    (130, 5, 16, 300),  # 3 blocks of 44 channels (the last 42): a third round mostly idle
    (160, 5, 8, 500),   # 3 blocks of 54 channels at 8 states, 2 rounds
    (72, 3, 32, 300),   # 2 blocks of 36 channels at 32 states, 5 rounds
])
def test_mamba_fused_backward_matches_plain(D, R, N, L, reverse, dtype):
    """Several chunks and a single chunk (no combine pass: the forward must
    leave a zero entry state for the backward to read); the edges of pass
    C's layout: state counts of 8 and 32, widths 2 to 384, tokens that end
    inside a sub-chunk; a chunk whole in one block (D <= 16) and split over
    a cluster of channel blocks, unevenly at D 130."""
    dev = _device()
    rng = np.random.default_rng(D * L + reverse + (N != 16) * N)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    W, B = 4, 2
    xz = torch.cat([f(B, 1, D, L) * 0.5, f(B, 1, D, L)], dim=2).to(dtype)
    args = [xz, f(1, D, W) * 0.4, f(1, D) * 0.1, f(1, R + 2 * N, D) * D ** -0.5,
            f(1, D, R) * R ** -0.5, f(1, D) * 0.1 - 4.0, -torch.exp(f(1, D, N) * 0.5),
            f(1, D)]
    dout = f(B, 1, D, L).to(dtype)
    before = mamba_fused_scan.bwd_launches
    got = _grads(lambda *a: mamba_fused_scan(*a, reverse=reverse), args, dout)
    assert mamba_fused_scan.bwd_launches == before + 1
    want = _grads(lambda *a: mamba_fused_scan_ref(*a, reverse=reverse), args, dout)
    assert got[0].dtype == dtype and all(g.dtype == torch.float32 for g in got[1:])
    _close_grads(got, want, dtype, ["xz", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b", "A", "D"])


def _lm_width_inputs(dev, dtype, L=300, B=2, D=1536):
    """Kernel 2's inputs at the Mamba LM's d_inner (mamba-130m: D 1536,
    dt_rank 48; mamba-370m: D 2048, dt_rank 64): chunks of 16 tokens, each
    split over a cluster of 8 blocks of 192 or 256 channels; 300 tokens end
    inside a chunk."""
    rng = np.random.default_rng(D + 1)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    R, N, W = D // 32, 16, 4
    xz = torch.cat([f(B, 1, D, L) * 0.5, f(B, 1, D, L)], dim=2).to(dtype)
    args = [xz, f(1, D, W) * 0.4, f(1, D) * 0.1, f(1, R + 2 * N, D) * D ** -0.5,
            f(1, D, R) * R ** -0.5, f(1, D) * 0.1 - 4.0, -torch.exp(f(1, D, N) * 0.5), f(1, D)]
    return args, f(B, 1, D, L).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1536, 2048])
def test_mamba_fused_backward_at_the_lm_width(D, dtype):
    dev = _device()
    args, dout = _lm_width_inputs(dev, dtype, D=D)
    got = _grads(mamba_fused_scan, args, dout)
    want = _grads(mamba_fused_scan_ref, args, dout)
    _close_grads(got, want, dtype, ["xz", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b", "A", "D"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,R,L", [(6, 1, 1000), (128, 4, 700), (1536, 48, 300)])
def test_mamba_fused_backward_is_the_same_from_run_to_run(D, R, L, dtype):
    """Every sum of kernel 2 has a fixed order (no atomics): two backward
    calls on the same inputs give the same bits, for a chunk in one block,
    and split over a cluster at D 128 and at the LM's width."""
    dev = _device()
    if D == 1536:
        args, dout = _lm_width_inputs(dev, dtype, L)
    else:
        rng = np.random.default_rng(D + L)
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
        N, W, B = 16, 4, 2
        args = [torch.cat([f(B, 1, D, L) * 0.5, f(B, 1, D, L)], dim=2).to(dtype),
                f(1, D, W) * 0.4, f(1, D) * 0.1, f(1, R + 2 * N, D) * D ** -0.5,
                f(1, D, R) * R ** -0.5, f(1, D) * 0.1 - 4.0, -torch.exp(f(1, D, N) * 0.5),
                f(1, D)]
        dout = f(B, 1, D, L).to(dtype)
    first = _grads(mamba_fused_scan, args, dout)
    second = _grads(mamba_fused_scan, args, dout)
    for name, a, b in zip(["xz", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b", "A", "D"],
                          first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_mamba_fused_backward_without_conv_bias():
    dev = _device()
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    D, R, L, N = 8, 1, 300, 16
    args = [torch.cat([f(1, 1, D, L) * 0.5, f(1, 1, D, L)], dim=2), f(1, D, 4) * 0.4, None,
            f(1, R + 2 * N, D) * D ** -0.5, f(1, D, R), f(1, D) * 0.1 - 4.0,
            -torch.exp(f(1, D, N) * 0.5), f(1, D)]
    dout = f(1, 1, D, L)
    got = _grads(mamba_fused_scan, args, dout)
    want = _grads(mamba_fused_scan_ref, args, dout)
    assert got[2] is None
    _close_grads(got, want, torch.float32, ["xz", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b",
                                            "A", "D"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,F,K,rows", [(24, 31, 64, 64, 3, "near"), (16, 23, 32, 16, 3, "near"),
                                            (16, 23, 128, 64, 1, "near"), (1, 8, 8, 24, 3, "near"),
                                            *TAP_EDGES, *TAP_UM_NET])
def test_tap_conv_backward_matches_plain(H, W, C, F, K, rows, dtype):
    """Every dkernel tile shape (F <= 16, <= 32 and wider), K = 1, 3 and 9,
    coordinates past both edges, a single-row map (no row to interpolate
    towards), the edges of TAP_EDGES and UM_Net's shapes."""
    dev = _device()
    rng = np.random.default_rng(H * C + K + F + 1)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    feat = f(2, H, W, C).to(dtype)
    y = _tap_rows(rng, dev, 2, H, W, K, rows)
    args = [feat, y, f(K, 1, C, F) * (K * C) ** -0.5, f(F) * 0.1]
    dout = f(2, H, W, F).to(dtype)
    shifts = [j - K // 2 for j in range(K)]
    before = tap_conv.bwd_launches
    got = _grads(lambda *a: tap_conv(*a, shifts), args, dout)
    assert tap_conv.bwd_launches == before + 1
    want = _grads(lambda *a: tap_conv_ref(*a, shifts), args, dout)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    _close_grads(got, want, dtype, ["feat", "y", "kernel", "bias"])


# The tallest maps the backward's dfeat strip holds: one column of H rows x
# 20 floats beside the block's tiles, within the 227 KB a block may use
# (f32 with 9 taps; bf16 with 3).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,K,rows", [(torch.float32, 9, 1632), (torch.bfloat16, 3, 2521)])
def test_tap_conv_backward_refuses_maps_taller_than_its_strip(dtype, K, rows):
    """At the tallest map the strip holds the backward matches the plain
    version; one row more and it raises instead of overrunning shared
    memory."""
    dev = _device()
    rng = np.random.default_rng(rows + K)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    shifts = [j - K // 2 for j in range(K)]
    for H in (rows, rows + 1):
        W, C, F = 5, 16, 16
        args = [f(1, H, W, C).to(dtype), _tap_rows(rng, dev, 1, H, W, K, "near"),
                f(K, 1, C, F) * (K * C) ** -0.5, f(F) * 0.1]
        dout = f(1, H, W, F).to(dtype)
        if H > rows:
            with pytest.raises(RuntimeError, match="tap_conv_bwd"):
                _grads(lambda *a: tap_conv(*a, shifts), args, dout)
            continue
        got = _grads(lambda *a: tap_conv(*a, shifts), args, dout)
        want = _grads(lambda *a: tap_conv_ref(*a, shifts), args, dout)
        _close_grads(got, want, dtype, ["feat", "y", "kernel", "bias"])


# The chunked selective scan (csrc/selective_scan_{fwd,bwd}.cu) through the
# `selective_scan` entry point against its plain version on the card: the
# fused flags with grouped B/C (channels per group not a multiple of the
# block), the bare scan with its last state, a constant (D, N) B/C, a state
# count that is not a power of two, one chunk, and a B/C read through the
# strides of a slice. Forward tolerance as TOL, gradients as BWD_TOL.
SCAN_CASES = [
    # batch, dim, L, N, B/C kind (G, "const", or "slice" / "slice3": views of
    # one (B, G, R + 2N, L) tensor with G = 2 / 3), fused flags, last state
    (2, 12, 300, 16, 2, True, False),
    (2, 18, 700, 16, 3, True, False),
    (2, 12, 300, 16, 1, False, True),
    (2, 40, 200, 16, "const", True, False),
    (2, 9, 150, 5, 3, True, True),
    (1, 6, 50, 16, 1, True, False),
    (2, 96, 260, 16, "slice", True, False),
    (2, 12, 300, 8, 2, True, True),           # N = 8: two channels per 16 lanes
    (1, 6, 300, 32, 1, True, True),           # N = 32: one channel per warp
    (2, 3, 150, 5, 3, True, True),            # N = 5, each group one channel's lane group
    (1, 12, 263, 16, 2, True, False),         # L ends 7 tokens into a sub-chunk
    (2, 12, 128, 16, 2, True, True),          # exactly one chunk
    (2, 384, 300, 16, "slice3", True, False),  # MM_Net's route b: G = 3, D = 128 per group
    (2, 80, 200, 16, 2, True, False),         # span 40: the second block holds 8 channels
]


def _scan_args(dev, batch, dim, L, N, bc, fused, dtype):
    rng = np.random.default_rng(batch * dim + L + N)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    u = f(batch, dim, L).to(dtype)
    delta = (f(batch, dim, L) * 0.5 if fused else f(batch, dim, L).abs() * 0.2).to(dtype)
    A = -torch.exp(f(dim, N) * 0.5)
    if bc == "const":
        B, C = f(dim, N), f(dim, N)
    elif bc in ("slice", "slice3"):  # views of one (B, G, R + 2N, L) tensor, as Mamba passes them
        x_dbl = f(batch, 2 if bc == "slice" else 3, 3 + 2 * N, L).to(dtype)
        B, C = x_dbl[:, :, 3:3 + N], x_dbl[:, :, 3 + N:]
    elif bc == 1:
        B, C = f(batch, N, L).to(dtype), f(batch, N, L).to(dtype)
    else:
        B, C = f(batch, bc, N, L).to(dtype), f(batch, bc, N, L).to(dtype)
    D, z, bias = (f(dim), f(batch, dim, L).to(dtype), f(dim) * 0.1) if fused else (None, None, None)
    return [u, delta, A, B, C, D, z, bias], f(batch, dim, L).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,dim,L,N,bc,fused,last", SCAN_CASES)
def test_selective_scan_kernels_match_plain(batch, dim, L, N, bc, fused, last, dtype):
    from mm_unet_tpu_torch.ops.chunked_scan import selective_scan_chunked
    from mm_unet_tpu_torch.ops.selective_scan import selective_scan, selective_scan_ref

    dev = _device()
    args, dout = _scan_args(dev, batch, dim, L, N, bc, fused, dtype)

    def run(fn):
        ins = [None if t is None else t.detach().clone().requires_grad_(True) for t in args]
        res = fn(*ins[:5], D=ins[5], z=ins[6], delta_bias=ins[7], delta_softplus=fused,
                 return_last_state=last)
        out = res[0] if last else res
        out.backward(dout)
        return out, (res[1] if last else None), [None if t is None else t.grad for t in ins]

    before = (selective_scan_chunked.launches, selective_scan_chunked.bwd_launches)
    got, got_last, got_g = run(selective_scan)
    assert (selective_scan_chunked.launches, selective_scan_chunked.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    want, want_last, want_g = run(selective_scan_ref)
    assert got.dtype == dtype and got.shape == (batch, dim, L)
    _close(got, want, dtype)
    if last:
        _close(got_last, want_last, torch.float32)
    for g, w, t in zip(got_g, want_g, args):
        if t is not None:
            assert g.dtype == t.dtype and g.shape == t.shape
    _close_grads(got_g, want_g, dtype, ["u", "delta", "A", "B", "C", "D", "z", "delta_bias"])


@pytest.mark.cuda
def test_dkdualnet_routes_agree_on_the_card():
    """A small dkDualNet in train mode: the megakernel route and the grouped
    scan route, logits and every parameter gradient, f32."""
    from mm_unet_tpu_torch.models import give_model

    dev = _device()
    m = give_model("dkDualNet", device=dev, generator=torch.Generator().manual_seed(0),
                   dims=(16, 32, 64, 128), depths=(1, 1, 1, 1), drop_path_rate=0.0).train()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 64, 64))
                         .astype(np.float32)).to(dev)
    res = {}
    for impl in (None, "pallas"):
        m.scan_impl = impl
        m.zero_grad()
        out = m(x)
        out.square().mean().backward()
        res[impl] = (out.detach(), {k: p.grad.clone() for k, p in m.named_parameters()})
    _close(res["pallas"][0], res[None][0], torch.float32)
    for k, g in res[None][1].items():
        err = (res["pallas"][1][k] - g).abs().max().item()
        assert err <= 1e-3 * (1.0 + g.abs().max().item()), (k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_fused_kernel_at_the_lm_width(dtype):
    """Kernel 1 at the Mamba LM's d_inner (mamba-130m: D 1536, dt_rank 48),
    whose chunks of 16 tokens split over 6 blocks of 256 channels behind
    the x_dbl pass (a whole chunk, 214,336 B of shared memory, would hold an
    SM alone); 300 tokens end inside a chunk."""
    dev = _device()
    rng = np.random.default_rng(1536)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    D, R, N, W, L = 1536, 48, 16, 4, 300
    xz = torch.cat([f(2, 1, D, L) * 0.5, f(2, 1, D, L)], dim=2).to(dtype)
    args = (f(1, D, W) * 0.4, f(1, D) * 0.1, f(1, R + 2 * N, D) * D ** -0.5,
            f(1, D, R) * R ** -0.5, f(1, D) * 0.1 - 4.0, -torch.exp(f(1, D, N) * 0.5),
            torch.ones(1, D, device=dev))
    _close(mamba_fused_scan(xz, *args), mamba_fused_scan_ref(xz, *args), dtype)


def _wide_inputs(dev, dtype, D, R, L, B=2, N=16, W=4, seed=2048):
    """xz and the seven weights of kernel 1 at width D, seeded."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    xz = torch.cat([f(B, 1, D, L) * 0.5, f(B, 1, D, L)], dim=2).to(dtype)
    return xz, (f(1, D, W) * 0.4, f(1, D) * 0.1, f(1, R + 2 * N, D) * D ** -0.5,
                f(1, D, R) * R ** -0.5, f(1, D) * 0.1 - 4.0, -torch.exp(f(1, D, N) * 0.5),
                torch.ones(1, D, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_fused_kernel_past_the_whole_chunk_tile(dtype):
    """Kernel 1 at mamba-370m's d_inner (D 2048, dt_rank 64), whose whole
    chunk would need 283,968 B of shared memory at 16-token chunks, past the
    card's 227 KB: each chunk's channels split over 8 blocks of 256 behind
    the x_dbl pass (`_fwd_plan`); 300 tokens end inside a chunk."""
    from mm_unet_tpu_torch.ops.mamba_fused import _fwd_plan

    dev = _device()
    assert _fwd_plan(2048, 96, 16)["nb"] == 8
    xz, args = _wide_inputs(dev, dtype, 2048, 64, 300)
    _close(mamba_fused_scan(xz, *args), mamba_fused_scan_ref(xz, *args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_fused_split_forward_is_the_same_from_run_to_run(dtype):
    """Two forward calls at D 2048 (8 channel blocks a chunk) give the same
    bits: output, chunk-entry states and sums of dt."""
    from mm_unet_tpu_torch.ops.mamba_fused import _kernel_operands, _launch_fwd

    dev = _device()
    xz, args = _wide_inputs(dev, dtype, 2048, 64, 300)
    w = _kernel_operands(xz, *args)
    first, second = _launch_fwd(xz, w, False), _launch_fwd(xz, w, False)
    for name, a, b in zip(["out", "state", "dtsum"], first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,R,N,L,Dc,reverse", [
    (128, 4, 16, 700, 48, False),   # 3 blocks, the last of 32 channels
    (128, 4, 16, 700, 48, True),
    (7, 1, 8, 500, 3, False),       # blocks of 3 channels: 24 live lanes of a warp
    (8, 1, 32, 37, 5, True),        # one chunk, ragged; one channel per warp
    (1536, 48, 16, 300, 256, False),  # mamba-130m's width in 6 blocks, its plan
])
def test_mamba_fused_split_forward_gives_the_whole_chunks_bits(D, R, N, L, Dc, reverse, dtype):
    """A chunk's channels in blocks of Dc behind the x_dbl pass give the bits
    of the whole-chunk launch (forced with Dc = D): the x_dbl sums run over
    the channels in one order in both, and every other term is per
    channel; at D 1536 the split is the plan's own launch. (With one
    chunk there is no pass 1: the sums of dt are left unwritten, as the
    backward reads them only across chunks.)"""
    from mm_unet_tpu_torch.ops.mamba_fused import _fwd_plan, _kernel_operands, _launch_fwd

    dev = _device()
    assert _fwd_plan(D, R + 2 * N, N, D)["nb"] == 1 and _fwd_plan(D, R + 2 * N, N, Dc)["nb"] > 1
    xz, args = _wide_inputs(dev, dtype, D, R, L, N=N, seed=D + L)
    w = _kernel_operands(xz, *args)
    whole, split = _launch_fwd(xz, w, reverse, D), _launch_fwd(xz, w, reverse, Dc)
    for name, a, b in zip(["out", "state", "dtsum"], whole, split):
        assert torch.equal(a, b) or (name == "dtsum" and a.shape[2] == 1), name


@pytest.mark.cuda
def test_mamba_fused_refuses_x_dbl_rows_past_the_shared_memory_opt_in():
    """The forward's limit: a block of its split chunk holds the E x_dbl rows
    and at least one channel's two rows, (2 + E) 17 floats at 16-token
    chunks, so E 3,417 is refused before any launch, with the shape; there
    is no fallback."""
    dev = _device()
    D, N, W, L = 3400, 16, 4, 32
    R = 3417 - 2 * N
    xz = torch.zeros(1, 1, 2 * D, L, device=dev)
    args = (torch.zeros(1, D, W, device=dev), None, torch.zeros(1, R + 2 * N, D, device=dev),
            torch.zeros(1, D, R, device=dev), torch.zeros(1, D, device=dev),
            -torch.ones(1, D, N, device=dev), torch.ones(1, D, device=dev))
    with pytest.raises(ValueError, match=r"D 3400 \(E 3417, N 16\)"):
        mamba_fused_scan(xz, *args)


@pytest.mark.cuda
def test_graph_decoder_matches_the_eager_one():
    """A small Mamba LM on the card: `generate_scan` (one CUDA-graph replay
    per token) against `generate` (eager), greedy and sampled tokens equal,
    and the teacher-forced step logits of both against the forward's."""
    from mm_unet_tpu_torch.models.lm import MambaLMHeadModel, generate, generate_scan

    dev = _device()
    lm = MambaLMHeadModel(64, 2, 50, rms_norm=True, fused_add_norm=True,
                          generator=torch.Generator().manual_seed(0)).to(dev).eval()
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, 50, (3, 5))).to(dev)
    greedy = [dec(lm, prompt, 9) for dec in (generate, generate_scan)]
    assert torch.equal(greedy[0], greedy[1])
    sampled = [dec(lm, prompt, 9, top_k=10, top_p=0.9,
                   generator=torch.Generator(device=dev).manual_seed(1))
               for dec in (generate, generate_scan)]
    assert torch.equal(sampled[0], sampled[1])
    with torch.no_grad():
        want = lm(greedy[0])
    for dec in (generate, generate_scan):
        tokens, logits = dec(lm, prompt, 9, teacher_outputs=greedy[0], return_logits=True)
        assert torch.equal(tokens, greedy[0])
        err = (logits - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.cuda
def test_loops_never_wait_on_the_whole_stream():
    """Two `train_one_epoch` steps and two `val_one_epoch` batches of a
    small MM_Net under `torch.cuda.set_sync_debug_mode("error")`: a blocking
    copy, `.item()` of a card tensor or a stream synchronise would raise.
    The training epoch's closing `torch.cuda.synchronize` is let through
    and counted: it is the only one."""
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.evaluate import val_one_epoch
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.train.inferers import SlidingWindowInferer
    from mm_unet_tpu_torch.train.loop import train_one_epoch
    from mm_unet_tpu_torch.train.metrics import build_metrics
    from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn

    dev = _device()
    model = give_model("MM_Net", device=dev, generator=torch.Generator().manual_seed(0),
                       depths=(1, 1, 1, 1), num_slices_list=(4, 4, 4, 4))
    state = create_train_state(model, {"trainer": dict(lr=1e-3, warmup=1, num_epochs=2)})
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    batches = [synthetic_batch(2, 64, i) for i in range(4)]
    real, calls = torch.cuda.synchronize, []

    def counted(device=None):
        calls.append(device)
        torch.cuda.set_sync_debug_mode(0)
        try:
            real(device)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    torch.cuda.synchronize = counted
    torch.cuda.set_sync_debug_mode("error")
    try:
        train_one_epoch(state, loss_fn, batches[:2], build_metrics())
        val_one_epoch(model, loss_fn, SlidingWindowInferer((64, 64)), batches[2:],
                      build_metrics())
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize = real
    assert len(calls) == 1 and state.step == 2


@pytest.mark.cuda
def test_seg_stats_on_the_card_are_the_host_mask_stats():
    """`trainer.seg_stats` on the card against `metrics.mask_stats` of the
    same thresholded masks on the host, at the serving cell's (32, 1, 512,
    512), exactly: the counts are integers, exact in f32 below 2^24 pixels a
    plane. Sample 0 predicts nothing and has no target, sample 1 predicts and
    holds every pixel, so the metrics' 0/0 (NaN) cases are reached; the seven
    metrics fed either way aggregate to the same bits."""
    from mm_unet_tpu_torch.train.metrics import build_metrics, mask_stats
    from mm_unet_tpu_torch.train.trainer import seg_stats

    dev = _device()
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (32, 1, 512, 512)
    logits = torch.randn(shape, generator=g, device=dev) * 4
    labels = (torch.rand(shape, generator=g, device=dev) < 0.3).float()
    logits[0], labels[0] = -10.0, 0.0
    logits[1], labels[1] = 10.0, 1.0
    stats = seg_stats(logits, labels)
    preds = (torch.sigmoid(logits) > 0.5).float().cpu().numpy()
    want = mask_stats(preds, labels.cpu().numpy())
    got = {k: stats[k].cpu().numpy() for k in ("inter", "psum", "tsum")}
    assert stats["npix"] == want["npix"] == 512 * 512
    for k, v in got.items():
        assert v.shape == (32, 1) and v.dtype == np.float32, k
        np.testing.assert_array_equal(v.astype(np.float64), want[k], err_msg=k)
    assert got["psum"][0, 0] == got["tsum"][0, 0] == 0
    assert got["inter"][1, 0] == got["psum"][1, 0] == got["tsum"][1, 0] == 512 * 512
    from_stats, from_masks = build_metrics(), build_metrics()
    for m in from_stats.values():
        m.update_stats({**got, "npix": stats["npix"]})
    for m in from_masks.values():
        m(y_pred=preds, y=labels.cpu().numpy())
    for name, m in from_stats.items():
        np.testing.assert_array_equal(m.aggregate(), from_masks[name].aggregate(), err_msg=name)
