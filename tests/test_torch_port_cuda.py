"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test decides inside itself whether there is a device and
skips without one. The file imports no jax, so on a machine without JAX it
runs on its own:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

The shapes are small but cut the sequence into several chunks (so the chunk
combine of the scan runs) and take both tile shapes of the tap-conv kernel
(F <= 16 and wider). Tolerance, as max |kernel - plain| <= tol * (1 + max
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
