"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test decides inside itself whether there is a device and
skips without one. The file imports no jax, so on a machine without JAX it
runs on its own:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

The shapes are small but cut the sequence into several chunks (so the chunk
combine of the scans runs) and take both tile shapes of the tap-conv kernel
(F <= 16 and wider); the selective scan takes every layout and flag it has. Tolerance, as max |kernel - plain| <= tol * (1 + max
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
@pytest.mark.parametrize("D,R,L", [(6, 1, 1000), (128, 4, 700)])
def test_mamba_fused_kernel_matches_plain(D, R, L, reverse, dtype):
    dev = _device()
    rng = np.random.default_rng(D + L)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    N, W, B = 16, 4, 2
    xz = torch.cat([f(B, 1, D, L) * 0.5, f(B, 1, D, L)], dim=2).to(dtype)
    args = (f(1, D, W) * 0.4, f(1, D) * 0.1, f(1, R + 2 * N, D) * D ** -0.5,
            f(1, D, R) * R ** -0.5, f(1, D) * 0.1 - 4.0, -torch.exp(f(1, D, N) * 0.5),
            torch.ones(1, D, device=dev))
    before = mamba_fused_scan.launches
    got = mamba_fused_scan(xz, *args, reverse=reverse)
    assert mamba_fused_scan.launches == before + 1
    assert got.shape == (B, 1, D, L) and got.dtype == dtype and got.is_cuda
    _close(got, mamba_fused_scan_ref(xz, *args, reverse=reverse), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,C,F,K", [(24, 64, 64, 3), (16, 32, 16, 3), (16, 128, 64, 1)])
def test_tap_conv_kernel_matches_plain(hw, C, F, K, dtype):
    dev = _device()
    rng = np.random.default_rng(hw * C + K)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    feat = f(2, hw, hw, C).to(dtype)
    rows = torch.arange(hw, dtype=torch.float32, device=dev)[None, :, None, None]
    y = rows + 2.0 * f(2, hw, hw, K)  # reaches past both edges
    kernel, bias = f(K, 1, C, F) * (K * C) ** -0.5, f(F) * 0.1
    shifts = [j - K // 2 for j in range(K)]
    before = tap_conv.launches
    got = tap_conv(feat, y, kernel, bias, shifts)
    assert tap_conv.launches == before + 1
    assert got.shape == (2, hw, hw, F) and got.dtype == dtype and got.is_cuda
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
    (384, 12, 16, 200),  # chunks of 16 = one sub-chunk, 12 rounds of (d, n) pairs
    (8, 1, 8, 500),     # four channels per warp
    (8, 1, 32, 500),    # one channel per warp
    (96, 6, 16, 37),    # one chunk, ragged
])
def test_mamba_fused_backward_matches_plain(D, R, N, L, reverse, dtype):
    """Several chunks and a single chunk (no combine pass: the forward must
    leave a zero entry state for the backward to read); the edges of pass
    C's layout: state counts of 8 and 32, widths 2 to 384, tokens that end
    inside a sub-chunk."""
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
@pytest.mark.parametrize("hw,C,F,K", [(24, 64, 64, 3), (16, 32, 16, 3), (16, 128, 64, 1),
                                      (1, 8, 24, 3)])
def test_tap_conv_backward_matches_plain(hw, C, F, K, dtype):
    """Both dkernel tile shapes (F <= 16 and wider), K = 1 and 3, coordinates
    past both edges, and a single-row map (no row to interpolate towards)."""
    dev = _device()
    rng = np.random.default_rng(hw * C + K + 1)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    feat = f(2, hw, hw + 7, C).to(dtype)
    rows = torch.arange(hw, dtype=torch.float32, device=dev)[None, :, None, None]
    y = rows + 2.0 * f(2, hw, hw + 7, K)
    args = [feat, y, f(K, 1, C, F) * (K * C) ** -0.5, f(F) * 0.1]
    dout = f(2, hw, hw + 7, F).to(dtype)
    shifts = [j - K // 2 for j in range(K)]
    before = tap_conv.bwd_launches
    got = _grads(lambda *a: tap_conv(*a, shifts), args, dout)
    assert tap_conv.bwd_launches == before + 1
    want = _grads(lambda *a: tap_conv_ref(*a, shifts), args, dout)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    _close_grads(got, want, dtype, ["feat", "y", "kernel", "bias"])


# The chunked selective scan (csrc/selective_scan_{fwd,bwd}.cu) through the
# `selective_scan` entry point against its plain version on the card: the
# fused flags with grouped B/C (channels per group not a multiple of the
# block), the bare scan with its last state, a constant (D, N) B/C, a state
# count that is not a power of two, one chunk, and a B/C read through the
# strides of a slice. Forward tolerance as TOL, gradients as BWD_TOL.
SCAN_CASES = [
    # batch, dim, L, N, B/C kind (G, or "const"), fused flags, last state
    (2, 12, 300, 16, 2, True, False),
    (2, 18, 700, 16, 3, True, False),
    (2, 12, 300, 16, 1, False, True),
    (2, 40, 200, 16, "const", True, False),
    (2, 9, 150, 5, 3, True, True),
    (1, 6, 50, 16, 1, True, False),
    (2, 96, 260, 16, "slice", True, False),
]


def _scan_args(dev, batch, dim, L, N, bc, fused, dtype):
    rng = np.random.default_rng(batch * dim + L + N)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    u = f(batch, dim, L).to(dtype)
    delta = (f(batch, dim, L) * 0.5 if fused else f(batch, dim, L).abs() * 0.2).to(dtype)
    A = -torch.exp(f(dim, N) * 0.5)
    if bc == "const":
        B, C = f(dim, N), f(dim, N)
    elif bc == "slice":  # B and C as views into one (B, G, R + 2N, L) tensor, as Mamba passes them
        x_dbl = f(batch, 2, 3 + 2 * N, L).to(dtype)
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
