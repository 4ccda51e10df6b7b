"""Chunked selective scan on the card: the CUDA kernel pair
`csrc/selective_scan_fwd.cu` / `csrc/selective_scan_bwd.cu` behind a
`torch.autograd.Function` (counterpart of
`mm_unet_tpu/ops/pallas_scan.py::selective_scan_pallas`).

The TPU package has two kernel pairs there: `_scan_core_fused` (softplus
prologue, D-skip and silu(z) epilogue in the kernel) and `_scan_core` (the
bare scan with its last state; prologue and epilogue in XLA). Here they are
one pair whose prologue (`bias`, `softplus`), epilogue (`D`, `z`) and last
state are flags, so every call, fused or bare, is one forward launch and one
backward launch. What bounds the kernels on the card and what their design
does about it is written at the head of each source.

Layout, as the JAX function takes it: u, delta, z (B, Dm, L); A (Dm, N); B/C
(B, N, L), (B, G, N, L) with channel d in group d // (Dm / G), or a constant
(Dm, N), each read through its strides (no copy, and no plain fallback for
the constant form); D, delta_bias (Dm,). The TPU pads channels to its block
and L to its chunk; the kernels mask their ragged edges instead.

Dtypes: u, delta and z share one stream dtype (f32 or bf16; mixed streams
are promoted to f32, which is exact), B and C one dtype of their own; the
state and every sum are f32; the output has u's dtype and every gradient its
input's. The last state takes no gradient, except through
`selective_scan_chunked_last`, the sequence-parallel scan's local scan, whose
last state's gradient seeds the backward kernel's carry.
`selective_scan_chunked.launches` and `.bwd_launches` count kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

_STREAM_DTYPES = (torch.float32, torch.bfloat16)
_SMEM_BUDGET = 200 * 1024  # bytes of shared memory a block of any pass may take
_MAX_T = 128               # longest chunk


@dataclass(frozen=True)
class _Plan:
    """How the kernels cut one call: states per channel rounded up to a
    power of two (NP), channels per span (blocks never straddle a B/C
    group), channels per block, tokens per chunk, and each B/C operand's
    strides over (batch, group, state, token), channels per group and
    whether it varies along the tokens."""

    NP: int
    span: int
    chans: int
    T: int
    strides: tuple
    gdiv: tuple
    var: tuple

    @property
    def n_blocks(self) -> int:  # blocks per span
        return -(-self.span // self.chans)


def _bc_layout(x: torch.Tensor, batch: int, dim: int, n: int, length: int, name: str):
    """(strides, channels per group, varies, groups) of one B/C operand."""
    if x.ndim == 2:
        if tuple(x.shape) != (dim, n):
            raise ValueError(f"selective_scan: constant {name} must be ({dim}, {n}), got {tuple(x.shape)}")
        return (0, x.stride(0), x.stride(1), 0), 1, False, dim
    if x.ndim == 3:
        if tuple(x.shape) != (batch, n, length):
            raise ValueError(f"selective_scan: {name} must be ({batch}, {n}, {length}), got {tuple(x.shape)}")
        return (x.stride(0), 0, x.stride(1), x.stride(2)), dim, True, 1
    if x.ndim == 4:
        g = x.shape[1]
        if tuple(x.shape) != (batch, g, n, length) or dim % g:
            raise ValueError(f"selective_scan: grouped {name} must be ({batch}, G, {n}, {length}) "
                             f"with {dim} % G == 0, got {tuple(x.shape)}")
        return tuple(x.stride()), dim // g, True, g
    raise ValueError(f"selective_scan: {name} has {x.ndim} dimensions")


def _smem_bytes(n: int, NP: int, chans: int, T: int) -> dict:
    """Dynamic shared memory, in bytes, that each chunk pass asks for at one
    block of `chans` channels and chunks of T tokens (as the launches in
    `csrc/selective_scan_{fwd,bwd}.cu` compute it): rows of T + 1 floats per
    channel and per state in the forward, T + 4 in the backward (read four
    tokens at a time); pass C's entry state of each thread's every sub-chunk
    of 16 tokens, and each warp's dB and dC terms of two sub-chunks in rows
    of NP + 1 floats."""
    threads = chans * NP
    return {"fwd_local": (2 * chans + n) * (T + 1) * 4,
            "fwd_final": (2 * chans + 2 * NP) * (T + 1) * 4,
            "bwd_local": (2 * chans + NP) * (T + 4) * 4,
            "bwd_chunk": ((5 * chans + 2 * NP) * (T + 4) + T // 16 * threads
                          + 4 * (threads // 32) * 16 * (NP + 1)) * 4}


def _plan(u: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> _Plan:
    batch, dim, length = u.shape
    n = A.shape[1]
    lb, lc = (_bc_layout(x, batch, dim, n, length, name) for x, name in ((B, "B"), (C, "C")))
    groups = math.lcm(*(lay[3] for lay in (lb, lc) if lay[2]), 1)
    span = dim // groups
    NP = 1 << (n - 1).bit_length()
    per_warp = 32 // NP  # channels in one warp
    chans = min(512 // NP, -(-span // per_warp) * per_warp)
    T = _MAX_T  # the longest chunk that fits, then fewer channels
    while (max(_smem_bytes(n, NP, chans, T).values()) > _SMEM_BUDGET
           and (T > 16 or chans > per_warp)):
        if T > 16:
            T //= 2
        else:
            chans = max(per_warp, chans // 2 // per_warp * per_warp)
    return _Plan(NP, span, chans, T, lb[0] + lc[0], (lb[1], lc[1]), (lb[2], lc[2]))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _shape_args(u, A, plan: _Plan, softplus: bool, B: torch.Tensor):
    """The C entry points' trailing arguments (after the B/C strides)."""
    batch, dim, length = u.shape
    return (*plan.gdiv, *map(int, plan.var), batch, dim, length, A.shape[1], plan.T, plan.span,
            plan.chans, int(softplus), int(u.dtype == torch.bfloat16),
            int(B.dtype == torch.bfloat16), torch.cuda.current_stream(u.device).cuda_stream)


def _launch_fwd(u, delta, z, A, B, C, D, bias, softplus, want_last, plan):
    """The forward kernel: (out, state, dtsum, last); the chunk-entry states
    and per-chunk sums of dt are kept for the backward."""
    from mm_unet_tpu_torch import _build

    batch, dim, length = u.shape
    dev = u.device
    n_chunks = -(-length // plan.T)
    out = torch.empty_like(u)
    state = torch.empty(batch, n_chunks, dim, A.shape[1], device=dev)
    dtsum = torch.empty(batch, n_chunks, dim, device=dev)
    last = torch.empty(batch, dim, A.shape[1], device=dev) if want_last else None
    strides = (ctypes.c_int64 * 8)(*plan.strides)
    err = _build.library().selective_scan_fwd(
        u.data_ptr(), delta.data_ptr(), _ptr(z), B.data_ptr(), C.data_ptr(), A.data_ptr(),
        _ptr(bias), _ptr(D), out.data_ptr(), state.data_ptr(), dtsum.data_ptr(), _ptr(last),
        ctypes.addressof(strides), *_shape_args(u, A, plan, softplus, B),
    )
    _build.check(err, "selective_scan_fwd")
    selective_scan_chunked.launches += 1
    return out, state, dtsum, last


def _launch_bwd(dout, u, delta, z, A, B, C, D, bias, state, dtsum, softplus, plan, dlast=None):
    """The backward kernel: (du, ddelta, dA, dB, dC, dD, dz, dbias), the
    parameter gradients and dB/dC summed over the kernel's per-block f32
    partials (as core_bwd sums over batch and channel blocks). `dlast`
    (B, Dm, N) f32, the last state's gradient, seeds the adjoint carry."""
    from mm_unet_tpu_torch import _build

    batch, dim, length = u.shape
    n, dev = A.shape[1], u.device
    n_chunks = state.shape[1]
    f32 = dict(device=dev)
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    dz = None if z is None else torch.empty_like(u)
    gcarry = torch.empty(batch, n_chunks, dim, n, **f32)
    p_dA = torch.empty(batch, n_chunks, dim, n, **f32)
    p_dD = None if D is None else torch.empty(batch, n_chunks, dim, **f32)
    p_dbias = None if bias is None else torch.empty(batch, n_chunks, dim, **f32)
    spans = dim // plan.span

    def partial(var):
        if var:
            return torch.empty(batch, spans, plan.n_blocks, n, length, **f32)
        return torch.empty(batch, n_chunks, dim, n, **f32)

    p_dB, p_dC = partial(plan.var[0]), partial(plan.var[1])
    strides = (ctypes.c_int64 * 8)(*plan.strides)
    err = _build.library().selective_scan_bwd(
        u.data_ptr(), delta.data_ptr(), _ptr(z), B.data_ptr(), C.data_ptr(), A.data_ptr(),
        _ptr(bias), _ptr(D), state.data_ptr(), dtsum.data_ptr(), dout.data_ptr(), _ptr(dlast),
        du.data_ptr(), ddelta.data_ptr(), _ptr(dz), gcarry.data_ptr(), p_dA.data_ptr(),
        _ptr(p_dD), _ptr(p_dbias), p_dB.data_ptr(), p_dC.data_ptr(), ctypes.addressof(strides),
        *_shape_args(u, A, plan, softplus, B),
    )
    _build.check(err, "selective_scan_bwd")
    selective_scan_chunked.bwd_launches += 1

    def reduce(p, x, var):
        if not var:  # constant (Dm, N): sum over batch and chunks
            return p.sum((0, 1)).to(x.dtype)
        g = 1 if x.ndim == 3 else x.shape[1]
        s = p.view(batch, g, -1, n, length).sum(2)  # the group's spans and blocks
        return (s[:, 0] if x.ndim == 3 else s).to(x.dtype)

    sums = [None if p is None else p.sum((0, 1)) for p in (p_dD, p_dbias)]
    return (du, ddelta, p_dA.sum((0, 1)), reduce(p_dB, B, plan.var[0]),
            reduce(p_dC, C, plan.var[1]), sums[0], dz, sums[1])


class _SelectiveScanFn(torch.autograd.Function):
    """The forward kernel, keeping the chunk-entry states and per-chunk sums
    of dt for the backward kernel. Inputs arrive in the kernels' dtypes
    (the caller casts, so autograd carries each gradient back through its
    cast); the gradients come back in those dtypes. The last state takes a
    gradient only with `diff_last`."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, bias, softplus, want_last, diff_last=False):
        plan = _plan(u, A, B, C)
        out, state, dtsum, last = _launch_fwd(u, delta, z, A, B, C, D, bias, softplus,
                                              want_last, plan)
        ctx.plan, ctx.softplus = plan, softplus
        ctx.set_materialize_grads(False)  # an unused output's gradient arrives as None
        ctx.save_for_backward(u, delta, z, A, B, C, D, bias, state, dtsum)
        if want_last:
            if not diff_last:
                ctx.mark_non_differentiable(last)
            return out, last
        return out

    @staticmethod
    def backward(ctx, dout, dlast=None):
        u, delta, z, A, B, C, D, bias, state, dtsum = ctx.saved_tensors
        dout = torch.zeros_like(u) if dout is None else dout.to(u.dtype).contiguous()
        if dlast is not None:
            dlast = dlast.float().contiguous()
        du, ddelta, dA, dB, dC, dD, dz, dbias = _launch_bwd(
            dout, u, delta, z, A, B, C, D, bias, state, dtsum, ctx.softplus, ctx.plan, dlast)
        return du, ddelta, dA, dB, dC, dD, dz, dbias, None, None, None


def selective_scan_chunked(
    u: torch.Tensor,                         # (B, Dm, L)
    delta: torch.Tensor,                     # (B, Dm, L)
    A: torch.Tensor,                         # (Dm, N)
    B: torch.Tensor,                         # (B, N, L) | (B, G, N, L) | (Dm, N)
    C: torch.Tensor,                         # as B
    D: Optional[torch.Tensor] = None,        # (Dm,)
    z: Optional[torch.Tensor] = None,        # (B, Dm, L)
    delta_bias: Optional[torch.Tensor] = None,  # (Dm,)
    delta_softplus: bool = False,
    return_last_state: bool = False,
    _diff_last: bool = False,
):
    """The selective scan on CUDA tensors through the kernel pair:
    (B, Dm, L) in u's dtype and, with `return_last_state`, the (B, Dm, N)
    f32 last state. Differentiable w.r.t. every tensor input; the last state
    takes no gradient (see `selective_scan_chunked_last`)."""
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan_chunked: no kernel for device {u.device}")
    batch, dim, length = u.shape
    n = A.shape[1]
    if tuple(delta.shape) != (batch, dim, length) or (z is not None and z.shape != u.shape):
        raise ValueError("selective_scan: delta and z must have u's shape")
    if tuple(A.shape) != (dim, n) or not 1 <= n <= 32:
        raise ValueError(f"selective_scan: A must be ({dim}, N) with N <= 32, got {tuple(A.shape)}")
    streams = [delta] + ([] if z is None else [z])
    sd = u.dtype if u.dtype in _STREAM_DTYPES and all(t.dtype == u.dtype for t in streams) \
        else torch.float32
    bcd = B.dtype if B.dtype == C.dtype and B.dtype in _STREAM_DTYPES else torch.float32
    dev = u.device

    def vec(t):
        return None if t is None else t.to(dev).float().contiguous()

    res = _SelectiveScanFn.apply(
        u.to(sd).contiguous(), delta.to(sd).contiguous(), vec(A), B.to(dev, bcd),
        C.to(dev, bcd), vec(D), None if z is None else z.to(sd).contiguous(), vec(delta_bias),
        bool(delta_softplus), bool(return_last_state), bool(_diff_last),
    )
    if return_last_state:
        return res[0].to(u.dtype), res[1]
    return res.to(u.dtype)


def selective_scan_chunked_last(u, delta, A, B, C):
    """The bare scan (no prologue or epilogue) on CUDA tensors: (y, last
    state), both differentiable. The last state's gradient seeds the
    backward kernel's carry. The sequence-parallel scan's local scan
    (`parallel/sp.py`)."""
    return selective_scan_chunked(u, delta, A, B, C, return_last_state=True, _diff_last=True)


selective_scan_chunked.launches = 0
selective_scan_chunked.bwd_launches = 0
