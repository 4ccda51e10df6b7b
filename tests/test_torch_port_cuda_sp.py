"""Kernel 8's last-state gradient (the `dlast` seed of its pass B, and of
pass C when there is one chunk) against autograd of the plain scan, on the
card, and the public `selective_scan`'s last state, which still takes no
gradient. Marked `cuda`: each test decides inside itself whether there is
a device and skips without one. No JAX here:

    python -m pytest --noconftest -q tests/test_torch_port_cuda_sp.py

Tolerance, as max |kernel - plain| <= tol * (1 + max |plain|): f32 2e-4
(summation order only), bf16 1.6e-2 (two bf16 ulps), as
`test_torch_port_cuda.py`.
"""

import numpy as np
import pytest
import torch

from mm_unet_tpu_torch.ops.chunked_scan import selective_scan_chunked, selective_scan_chunked_last
from mm_unet_tpu_torch.ops.selective_scan import selective_scan, selective_scan_ref

TOL = {torch.float32: 2e-4, torch.bfloat16: 1.6e-2}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, dtype, what):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * (1.0 + want.float().abs().max().item()), (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dm,G,N,L", [(64, 1, 16, 700), (64, 2, 16, 90), (32, 1, 8, 1000),
                                      (48, 1, 16, 128)])
def test_scan_kernel_last_state_gradient_matches_plain(Dm, G, N, L, dtype):
    """Several chunks (pass B walks from dlast), one chunk (pass C starts
    from it), a ragged last chunk, grouped B/C."""
    dev = _device()
    rng = np.random.default_rng(Dm + L + G)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    B = 2
    u, dt = f(B, Dm, L).to(dtype), (0.5 * f(B, Dm, L).abs()).to(dtype)
    A = -torch.exp(0.3 * f(Dm, N))
    Bm, Cm = f(B, G, N, L).to(dtype), f(B, G, N, L).to(dtype)
    wy, wh = f(B, Dm, L), f(B, Dm, N)
    ins = [t.detach().requires_grad_() for t in (u, dt, A, Bm, Cm)]
    ref = [t.detach().float().requires_grad_() for t in (u, dt, A, Bm, Cm)]
    n0 = selective_scan_chunked.bwd_launches
    y, h = selective_scan_chunked_last(*ins)
    ((y.float() * wy).sum() + (h * wh).sum()).backward()
    assert selective_scan_chunked.bwd_launches == n0 + 1
    yr, hr = selective_scan_ref(*ref, return_last_state=True)
    ((yr * wy).sum() + (hr * wh).sum()).backward()
    torch.cuda.synchronize()
    _close(h, hr, dtype, "last")
    for name, a, b in zip(("u", "delta", "A", "B", "C"), ins, ref):
        _close(a.grad, b.grad, dtype, f"d{name}")


@pytest.mark.cuda
def test_public_scan_last_state_takes_no_gradient():
    dev = _device()
    u = torch.randn(1, 8, 300, device=dev, requires_grad=True)
    y, h = selective_scan(u, torch.rand(1, 8, 300, device=dev), -torch.rand(8, 4, device=dev),
                          torch.randn(1, 4, 300, device=dev), torch.randn(1, 4, 300, device=dev),
                          return_last_state=True)
    assert y.requires_grad and not h.requires_grad
