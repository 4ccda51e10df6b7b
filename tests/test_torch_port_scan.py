"""The port's selective-scan entry point against the JAX package, on the CPU.

On CPU tensors `selective_scan` takes its plain version, the oracle the
chunked scan kernels are held to on the card (tests/test_torch_port_cuda.py,
chip_smoke.py). Here it is held, forward and through autograd for every
input, to JAX `selective_scan_pallas(..., chunk=128)` in Pallas interpret
mode (kernels 5/6 with the fused flags, 7/8 bare with the last state), and
to JAX's associative scan for a constant (D, N) B/C. The shapes take grouped
B/C with G = 1, 2, 3, channels per group not a multiple of 8 (6), L not a
multiple of the chunk (300), and L over several of the JAX kernel's chunks.

Tolerances, as max |port - jax| <= tol * (1 + max |jax|): f32 1e-4 (the
chunked TPU scan and the token-by-token plain scan sum in different orders);
bf16 streams 3e-2 (both round the output and the stream gradients to bf16
once, from f32 sums taken in different orders: a bf16 ulp is 2^-8, and a
sum on a rounding boundary may land one ulp apart).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu_torch.ops.chunked_scan import (_SMEM_BUDGET, _plan, _smem_bytes,
                                                 selective_scan_chunked)
from mm_unet_tpu_torch.ops.selective_scan import IMPLEMENTATIONS, selective_scan
from torch_port_harness import assert_close

_ps = importlib.import_module("mm_unet_tpu.ops.pallas_scan")
_ss = importlib.import_module("mm_unet_tpu.ops.selective_scan")
NAMES = ["u", "delta", "A", "B", "C", "D", "z", "delta_bias"]
TOL = {np.float32: 1e-4, "bfloat16": 3e-2}


def _inputs(seed, batch, dim, L, N, bc, fused, bf16=False):
    """u, delta, A, B, C, D, z, delta_bias as float32 numpy (None where the
    variant has none); bc is G (grouped (B, G, N, L); 1 gives (B, N, L)) or
    "const" ((D, N))."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    u = f(batch, dim, L)
    # fused: delta is dt before bias and softplus; bare: dt itself, positive
    delta = f(batch, dim, L) * 0.5 if fused else rng.uniform(0.01, 0.3, (batch, dim, L)).astype(
        np.float32)
    A = -np.exp(f(dim, N) * 0.5)
    if bc == "const":
        B, C = f(dim, N), f(dim, N)
    elif bc == 1:
        B, C = f(batch, N, L), f(batch, N, L)
    else:
        B, C = f(batch, bc, N, L), f(batch, bc, N, L)
    D, z, bias = (f(dim), f(batch, dim, L), f(dim) * 0.1) if fused else (None, None, None)
    args = [u, delta, A, B, C, D, z, bias]
    if bf16:  # the streams and B/C in bf16; A, D, bias stay f32 parameters
        for i in (0, 1, 3, 4, 6):
            if args[i] is not None:
                args[i] = np.array(jnp.asarray(args[i], jnp.bfloat16).astype(jnp.float32))
    return args


def _jax_grads(fn, args, w, fused, want_last, dtype):
    """(out, last or None, gradient of every non-None input) of the JAX fn."""
    idx = [i for i, a in enumerate(args) if a is not None]

    def call(*live):
        full = [None] * len(args)
        for i, a in zip(idx, live):
            full[i] = a
        return fn(*full[:5], D=full[5], z=full[6], delta_bias=full[7],
                  delta_softplus=fused, return_last_state=want_last)

    def loss(*live):
        res = call(*live)
        out = res[0] if want_last else res
        return jnp.sum(out.astype(jnp.float32) * w)

    jargs = [jnp.asarray(args[i], dtype if i in (0, 1, 3, 4, 6) else jnp.float32) for i in idx]
    res = jax.jit(call)(*jargs)
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(idx)))))(*jargs)
    out, last = (res if want_last else (res, None))
    return out, last, dict(zip(idx, grads))


def _port(args, w, fused, want_last, dtype):
    th = [None if a is None else torch.from_numpy(a).to(dtype if i in (0, 1, 3, 4, 6)
                                                          else torch.float32).requires_grad_(True)
          for i, a in enumerate(args)]
    res = selective_scan(*th[:5], D=th[5], z=th[6], delta_bias=th[7], delta_softplus=fused,
                         return_last_state=want_last)
    out, last = (res if want_last else (res, None))
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out, last, th


@pytest.mark.parametrize("bc,dg,L,fused,want_last,bf16", [
    (1, 6, 300, True, False, False),   # fused flags, B/C (B, N, L)
    (2, 6, 300, True, False, False),   # fused, G = 2
    (3, 6, 300, True, False, False),   # fused, G = 3
    (2, 16, 300, True, False, False),  # 16 channels per group: three JAX chunks of 128
    (1, 6, 300, False, True, False),   # bare: no bias, softplus, D or z; with the last state
    (2, 8, 260, True, False, True),    # fused, bf16 streams and B/C
])
def test_selective_scan_matches_jax_pallas(bc, dg, L, fused, want_last, bf16):
    G = bc
    batch, dim, N = 2, G * dg, 16
    args = _inputs(10 * G + dg + L, batch, dim, L, N, bc, fused, bf16)
    w = np.random.default_rng(L).standard_normal((batch, dim, L)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    tol = TOL["bfloat16" if bf16 else np.float32]
    want, want_state, jgrads = _jax_grads(
        lambda *a, **k: _ps.selective_scan_pallas(*a, **k, chunk=128), args, w, fused,
        want_last, jdt)
    got, got_last, th = _port(args, w, fused, want_last, tdt)
    assert got.dtype == tdt and got.shape == (batch, dim, L)
    assert_close(got.detach().float().numpy(), np.asarray(want, np.float32), tol, "out")
    if want_last:
        assert got_last.shape == (batch, dim, N) and not got_last.requires_grad
        assert_close(got_last.numpy(), np.asarray(want_state), 1e-4, "last state")
    for i, g in jgrads.items():
        assert th[i].grad.dtype == th[i].dtype, NAMES[i]
        assert_close(th[i].grad.float().numpy(), np.asarray(g, np.float32), tol, f"d{NAMES[i]}")


@pytest.mark.parametrize("fused", [True, False])
def test_selective_scan_constant_bc_matches_jax_assoc(fused):
    """A constant (D, N) B/C: the JAX package takes its associative scan (its
    Pallas kernels need a varying B/C); the port's kernel reads it through
    stride-0 strides, and its plain version is held to JAX's here."""
    batch, dim, L, N = 2, 10, 120, 8
    args = _inputs(5 + fused, batch, dim, L, N, "const", fused)
    w = np.random.default_rng(3).standard_normal((batch, dim, L)).astype(np.float32)
    want, _, jgrads = _jax_grads(
        lambda *a, **k: _ss.selective_scan(*a, **k, implementation="assoc"), args, w, fused,
        False, jnp.float32)
    got, _, th = _port(args, w, fused, False, torch.float32)
    assert_close(got.detach().numpy(), np.asarray(want), 1e-4, "out")
    for i, g in jgrads.items():
        assert_close(th[i].grad.numpy(), np.asarray(g), 1e-4, f"d{NAMES[i]}")


def test_selective_scan_implementations_agree_on_cpu():
    """Every implementation name takes the plain version on CPU tensors; an
    unknown one raises; the last state is detached."""
    args = _inputs(0, 2, 6, 40, 4, 2, True)
    th = [None if a is None else torch.from_numpy(a) for a in args]
    want = selective_scan(*th, delta_softplus=True)
    for impl in IMPLEMENTATIONS:
        torch.testing.assert_close(selective_scan(*th, delta_softplus=True, implementation=impl),
                                   want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="implementation"):
        selective_scan(*th, implementation="bypass")
    u = th[0].clone().requires_grad_(True)
    _, last = selective_scan(u, *th[1:], delta_softplus=True, return_last_state=True)
    assert not last.requires_grad


def test_chunked_scan_needs_a_cuda_tensor():
    args = [None if a is None else torch.from_numpy(a) for a in _inputs(1, 1, 6, 20, 4, 1, True)]
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        selective_scan_chunked(*args)


def test_plain_scan_backward_is_linear_in_tokens():
    """The plain scan takes its per-token slices from one unbind: the graph
    holds no per-token select, whose backward would write a whole-tensor
    gradient for every token (quadratic in L)."""
    from mm_unet_tpu_torch.ops.selective_scan import selective_scan_ref

    args = [None if a is None else torch.from_numpy(a).requires_grad_(True)
            for a in _inputs(2, 1, 6, 40, 4, 2, True)]
    out = selective_scan_ref(*args[:5], D=args[5], z=args[6], delta_bias=args[7],
                             delta_softplus=True)
    kinds, seen, todo = set(), set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        kinds.add(type(node).__name__)
        todo += [nxt for nxt, _ in node.next_functions]
    assert any(k.startswith("UnbindBackward") for k in kinds), kinds
    assert not any(k.startswith("SelectBackward") for k in kinds), kinds


# every selective-scan shape of a dkDualNet route-b train step at 512², batch
# 8 (three grouped scans, two directions each), and of MM_Net's Mambas on the
# grouped-scan route (three directions, D per group 2, 6 and 128), as
# chip_smoke.py's forward hooks record them: (batch, channels, G, N, dt_rank, L)
PLAN_SHAPES = [(8, 2 * d, 2, 16, r, L) for d, r, L in ((96, 3, 16384), (192, 6, 4096),
                                                          (384, 12, 1024))] + [
    (8, 3 * d, 3, 16, r, L) for d, r, L in (
        (2, 1, 256), (2, 1, 1024), (2, 1, 4096), (6, 1, 256), (6, 1, 1024), (6, 1, 4096),
        (6, 1, 16384), (6, 1, 65536), (128, 4, 4096), (128, 4, 16384), (128, 4, 65536))]


@pytest.mark.parametrize("batch,dim,G,N,R,L", PLAN_SHAPES)
def test_scan_plan_fits_the_kernels(batch, dim, G, N, R, L):
    """How the kernels cut a call at the main paths' shapes, B/C the views of
    one x_dbl as the Mamba passes them: chunks a multiple of the 16-token
    sub-chunk and at most 128 tokens, every pass's shared memory within the
    budget (itself within the H100's 227 KB a block), whole warps of at most
    512 threads, blocks inside one B/C group."""
    meta = dict(device="meta")
    x_dbl = torch.empty(batch, G, R + 2 * N, L, **meta)
    plan = _plan(torch.empty(batch, dim, L, **meta), torch.empty(dim, N, **meta),
                 x_dbl[:, :, R:R + N], x_dbl[:, :, R + N:])
    threads = plan.chans * plan.NP
    assert plan.T % 16 == 0 and 16 <= plan.T <= 128
    assert threads <= 512 and threads % 32 == 0
    assert plan.NP == 16 and plan.span == dim // G and plan.chans <= plan.span
    assert plan.var == (True, True) and plan.gdiv == (dim // G, dim // G)
    assert plan.strides == (x_dbl.stride() * 2)
    smem = _smem_bytes(N, plan.NP, plan.chans, plan.T)
    assert max(smem.values()) <= _SMEM_BUDGET <= 227 * 1024, smem
