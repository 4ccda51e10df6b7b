"""Fused Mamba-inner scan: causal conv + SiLU, x_proj, dt_proj + softplus,
selective scan and silu(z) gate over the packed in_proj output, and its
backward.

Counterpart of `mm_unet_tpu/ops/mamba_fused.py::mamba_fused_scan`, in the
same layout: xz (B, G, 2D, L) with the scan stream in rows
[0, D) and the gate in rows [D, 2D). `mamba_fused_scan` launches the CUDA
kernels for CUDA tensors: `csrc/mamba_fused_fwd.cu` forward and, through a
`torch.autograd.Function`, `csrc/mamba_fused_bwd.cu` backward from the
chunk-entry states the forward kept. For CPU tensors it takes the plain
`mamba_fused_scan_ref`, differentiated by autograd. `mamba_fused_scan.
launches` and `.bwd_launches` count kernel launches. Both kernels cut L
into chunks (`_chunk_len`) and, for wide Mambas, a chunk's channels into
blocks behind a pass that computes x_dbl once per chunk (`_fwd_plan`,
`_bwd_plan`).

Under a bf16 stream both versions round where the TPU kernel rounds: the
weights fed to the conv and the projections, the conv output, the dt rows of
x_dbl, and the gated output. The state and every sum stay f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from mm_unet_tpu_torch.ops.causal_conv1d import causal_conv1d
from mm_unet_tpu_torch.ops.selective_scan import selective_scan_ref

_STREAM_DTYPES = (torch.float32, torch.bfloat16)
_CONV_TILE = 1024  # tokens per block of the backward's depthwise conv pass
# tokens per sub-chunk of the forward's pass 3 and the backward's pass C (`kS`
# in csrc/mamba_chunk.cuh): a chunk must hold whole sub-chunks
_SUB_CHUNK = 16


def mamba_fused_scan_ref(xz, conv_w, conv_b, x_proj, dt_w, dt_b, A, D_skip,
                         reverse: bool = False) -> torch.Tensor:
    """Plain version: per group, causal conv -> einsum projections ->
    `selective_scan_ref` -> gate. The reverse direction flips, scans and
    flips back."""
    sd = xz.dtype
    _, G, D2, _ = xz.shape
    D, R, N = D2 // 2, dt_w.shape[2], A.shape[2]
    outs = []
    for g in range(G):
        x, z = xz[:, g, :D], xz[:, g, D:]
        if reverse:
            x, z = x.flip(-1), z.flip(-1)
        bias = None if conv_b is None else conv_b[g].float()
        u = causal_conv1d(x, conv_w[g].to(sd), bias, activation="silu").float()
        xdbl = torch.einsum("ed,bdl->bel", x_proj[g].to(sd).float(), u)
        dt = torch.einsum("dr,brl->bdl", dt_w[g].to(sd).float(), xdbl[:, :R].to(sd).float())
        y = selective_scan_ref(
            u, dt, A[g], xdbl[:, R : R + N], xdbl[:, R + N :], D=D_skip[g], z=z,
            delta_bias=dt_b[g], delta_softplus=True,
        ).to(sd)
        outs.append(y.flip(-1) if reverse else y)
    return torch.stack(outs, dim=1)


def _chunk_len(D: int, E: int) -> int:
    """Tokens per chunk of both kernels (the backward reads the forward's
    chunk-entry states): the largest power of two in [16, 256] whose f32
    shared-memory tile of the forward (u and dt for D channels, E x_dbl
    rows) fits 96 KB for wide Mambas or 24 KB for narrow ones (many small
    blocks per SM, to hide the scan's latency); a multiple of `_SUB_CHUNK`.
    It stops at 16, so a wide enough Mamba's whole-chunk tile, (2 D + E)
    (T + 1) 4 bytes in the forward (`_tile_bytes`), passes the budget: D
    128 keeps two resident forward blocks per SM; past two blocks' share of
    an SM (D > 810 at E 80 and T 16; the Mamba LM's D 1536 would take
    214,336 B, one block per SM, and D > 1,669 the card's 227 KB opt-in)
    the forward splits a chunk's channels over blocks (`_fwd_plan`), as the
    backward does (`_bwd_plan`)."""
    budget = (96 if D > 32 else 24) * 1024
    t = 256
    while t > 16 and (2 * D + E) * t * 4 > budget:
        t //= 2
    return t


_SMEM_OPT_IN = 232448  # bytes of shared memory a block may take on the H100
# the backward's blocks (csrc/mamba_fused_bwd.cu): at most _BWD_THREADS
# threads in passes A and C (one per (channel, state) pair; `kThreads`),
# _BWD_CHANNELS channels a block where a Mamba spans several, and at most
# _BWD_CLUSTER blocks a chunk (one thread-block cluster of the portable size)
_BWD_THREADS = 256
_BWD_CHANNELS = 64
_BWD_CLUSTER = 8


def _bwd_plan(D: int, E: int, N: int) -> dict:
    """The backward's launch for a Mamba of D channels, E = R + 2N x_dbl rows
    and N states, as `plan_of` in csrc/mamba_fused_bwd.cu computes it: the
    chunk length T (the forward's), nb blocks of Dc channels per chunk (nb
    = 1 for D <= _BWD_CHANNELS: one block recomputes the whole chunk, as
    before the split; else blocks of about _BWD_CHANNELS channels, wider
    past the 8 blocks of a cluster at 512 channels), the threads
    of a pass A or C block, and each pass's shared memory in bytes: rows of
    T + 1 floats; pass X (nb > 1) a slice of Dc conv outputs and E x_dbl
    rows, pass A u, dt, dy of Dc channels and x_dbl, pass C u, dt, dy, du
    of Dc channels, x_dbl and dx_dbl, the states entering each sub-chunk
    and each warp's dB and dC of a sub-chunk. Raises ValueError past the
    widest D a cluster of shared-memory-bound blocks can take."""
    T = _chunk_len(D, E)
    nb = 1 if D <= _BWD_CHANNELS else min(_BWD_CLUSTER, -(-D // _BWD_CHANNELS))
    Dc = -(-D // nb)
    nb = -(-D // Dc)

    def smem(Dc):
        threads = min(_BWD_THREADS, -(-Dc * N // 32) * 32)
        ld = T + 1
        return threads, {
            "x": (Dc + E) * ld * 4 if nb > 1 else 0,
            "a": (3 * Dc + E) * ld * 4,
            "c": ((4 * Dc + 2 * E) * ld + T // _SUB_CHUNK * threads
                  + threads // 32 * 2 * N * (_SUB_CHUNK + 1)) * 4,
        }

    threads, nbytes = smem(Dc)
    if max(nbytes.values()) > _SMEM_OPT_IN:
        widest = max(c for c in range(1, Dc + 1) if max(smem(c)[1].values()) <= _SMEM_OPT_IN)
        raise ValueError(
            f"mamba_fused_scan backward: D {D} (E {E}, N {N}) needs {nb} blocks of {Dc} channels "
            f"and {max(nbytes.values())} B of shared memory per block at T {T}, past the "
            f"{_SMEM_OPT_IN} B a block can take: a cluster of {_BWD_CLUSTER} blocks of at most "
            f"{widest} channels holds D <= {_BWD_CLUSTER * widest} at this E, N and T")
    return dict(T=T, Dc=Dc, nb=nb, threads=threads, bytes=nbytes)


def _tile_bytes(D: int, E: int, T: int) -> int:
    """The forward's shared-memory tile: rows of T + 1 floats for u and dt
    of D channels and E x_dbl rows (`plan_of`, csrc/mamba_fused_fwd.cu)."""
    return (2 * D + E) * (T + 1) * 4


_FWD_CHANNELS = 256  # most channels a block of a split forward chunk takes
# the most shared memory each of two blocks on one SM can take: half the
# H100's 228 KB an SM, less the 1 KB the runtime keeps for each block
_SMEM_TWO_PER_SM = 233472 // 2 - 1024


def _fwd_plan(D: int, E: int, N: int, Dc: Optional[int] = None) -> dict:
    """The forward's launch for a Mamba of D channels, E = R + 2N x_dbl rows
    and N states, as `plan_of` in csrc/mamba_fused_fwd.cu computes it: the
    chunk length T (`_chunk_len`), nb blocks of Dc channels per chunk, the
    threads of a block of passes 1 and 3 (one per (channel, state) pair, in
    whole warps, at most 512) and the shared memory in bytes of those passes
    (`chunk`) and of pass X (`x`, nb > 1: a slice of Dc conv outputs and the
    E x_dbl rows). nb = 1 wherever a chunk's D channels fit a tile
    (`_tile_bytes`) that two blocks of an SM can hold (up to D 810 at E 80
    and T 16: every Mamba of the zoo, HWAUNETR's D 768 at E 56 the widest).
    Past that, where one whole chunk would hold an SM alone or not fit at
    all, blocks of at most _FWD_CHANNELS channels, as few as cover D evenly
    (mamba-130m's D 1536: 6 of 256, two blocks per SM and the whole chunk's
    bits; mamba-370m's D 2048: 8 of 256), behind pass X. A split takes any
    D whose E rows and two channel rows fit a block (E <= 3,416 at T 16),
    and so every width `_bwd_plan` takes; past that it raises ValueError
    with the shape. `Dc` forces blocks of that many channels (Dc = D the
    whole chunk), for the card's checks of a split against a whole launch."""
    T = _chunk_len(D, E)
    ld = T + 1
    if Dc is None:
        if _tile_bytes(D, E, T) <= _SMEM_TWO_PER_SM:
            Dc = D
        else:
            widest = (_SMEM_OPT_IN // (4 * ld) - E) // 2
            Dc = min(_FWD_CHANNELS, max(widest, 0))
            if Dc < 1:
                raise ValueError(
                    f"mamba_fused_scan forward: D {D} (E {E}, N {N}) at T {T}: the {E} x_dbl "
                    f"rows and one channel's two rows take {_tile_bytes(1, E, T)} B of shared "
                    f"memory per block, past the {_SMEM_OPT_IN} B a block can take")
            Dc = -(-D // -(-D // Dc))  # the same block count, spread evenly
    Dc = min(Dc, D)
    nb = -(-D // Dc)
    nbytes = {"chunk": _tile_bytes(Dc, E, T), "x": (Dc + E) * ld * 4 if nb > 1 else 0}
    if max(nbytes.values()) > _SMEM_OPT_IN:
        raise ValueError(
            f"mamba_fused_scan forward: D {D} (E {E}, N {N}) in {nb} blocks of {Dc} channels "
            f"needs {max(nbytes.values())} B of shared memory per block at T {T}, past the "
            f"{_SMEM_OPT_IN} B a block can take")
    return dict(T=T, Dc=Dc, nb=nb, threads=min(512, -(-Dc * N // 32) * 32), bytes=nbytes)


def _kernel_operands(xz, conv_w, conv_b, x_proj, dt_w, dt_b, A, D_skip):
    """Check the shapes and bring the weights into the kernels' layout: f32,
    contiguous, on xz's device (the caller has rounded the ones the kernels
    multiply to the stream dtype), the conv bias zero when absent."""
    _, G, D2, _ = xz.shape
    D, R, N, W = D2 // 2, dt_w.shape[2], A.shape[2], conv_w.shape[2]
    if xz.dtype not in _STREAM_DTYPES:
        raise TypeError(f"mamba_fused_scan: stream dtype {xz.dtype} not in {_STREAM_DTYPES}")
    if D2 != 2 * D or conv_w.shape[:2] != (G, D) or x_proj.shape != (G, R + 2 * N, D):
        raise ValueError("mamba_fused_scan: inconsistent shapes")
    if N > 32 or N & (N - 1):
        raise ValueError(f"mamba_fused_scan: d_state {N} must be a power of two <= 32")
    if R > D or W > 8:
        raise ValueError(f"mamba_fused_scan: needs dt_rank {R} <= d_inner {D}, conv width {W} <= 8")
    dev = xz.device
    cb = torch.zeros(G, D, device=dev) if conv_b is None else conv_b
    return [t.to(dev).float().contiguous() for t in (conv_w, cb, x_proj, dt_w, dt_b, A, D_skip)]


def _launch_fwd(xz, w, reverse, Dc: Optional[int] = None):
    """The forward kernel on CUDA tensors; `w` from `_kernel_operands`, the
    launch from `_fwd_plan` (`Dc` forces its channel blocks). Returns (out,
    state, dtsum): the gated output and, for the backward, the chunk-entry
    states and per-chunk sums of dt."""
    from mm_unet_tpu_torch import _build

    Bsz, G, D2, L = xz.shape
    D, R, N, W = D2 // 2, w[3].shape[2], w[5].shape[2], w[0].shape[2]
    E, sd, dev = R + 2 * N, xz.dtype, xz.device
    plan = _fwd_plan(D, E, N, Dc)
    n_chunks = -(-L // plan["T"])
    state = torch.empty(Bsz, G, n_chunks, D, N, device=dev)
    dtsum = torch.empty(Bsz, G, n_chunks, D, device=dev)
    out = torch.empty(Bsz, G, D, L, dtype=sd, device=dev)
    # x_dbl of every chunk, from pass X, where a chunk spans several blocks;
    # not kept for the backward, which computes its own (kept, it would add
    # hundreds of MB to a model's peak memory)
    xdbl = torch.empty(Bsz, G, E, L, device=dev) if plan["nb"] > 1 else None
    err = _build.library().mamba_fused_fwd(
        xz.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in w),
        state.data_ptr(), dtsum.data_ptr(), None if xdbl is None else xdbl.data_ptr(),
        Bsz, G, D, L, N, R, W, plan["T"], plan["Dc"],
        int(reverse), int(sd == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, f"mamba_fused_fwd at B {Bsz}, G {G}, D {D}, L {L}, N {N}, R {R}, W {W}, "
                      f"T {plan['T']}, {plan['nb']} blocks of {plan['Dc']} channels a chunk "
                      f"({plan['bytes']['chunk']} B of shared memory per block)")
    mamba_fused_scan.launches += 1
    return out, state, dtsum


def _launch_bwd(dout, xz, w, state, dtsum, reverse):
    """The backward kernel: (dxz, dconv_w, dconv_b, dx_proj, ddt_w, ddt_b, dA,
    dD), the parameter gradients f32 (G, ...) summed over the kernel's
    per-block partials."""
    from mm_unet_tpu_torch import _build

    Bsz, G, D2, L = xz.shape
    D, R, N, W = D2 // 2, w[3].shape[2], w[5].shape[2], w[0].shape[2]
    E, sd, dev = R + 2 * N, xz.dtype, xz.device
    nC, nCT = state.shape[2], -(-L // _CONV_TILE)
    plan = _bwd_plan(D, E, N)
    dout = dout.to(sd).contiguous()
    dxz = torch.empty_like(xz)
    gcarry = torch.empty(Bsz, G, nC, D, N, device=dev)
    dpre = torch.empty(Bsz, G, D, L, device=dev)
    # x_dbl of every chunk, from pass X, where a chunk spans several blocks
    xdbl = torch.empty(Bsz, G, E, L, device=dev) if plan["nb"] > 1 else None
    p_dxp = torch.empty(Bsz, G, nC, E, D, device=dev)
    p_ddtw = torch.empty(Bsz, G, nC, D, R, device=dev)
    p_ddtb = torch.empty(Bsz, G, nC, D, device=dev)
    p_dA = torch.empty(Bsz, G, nC, D, N, device=dev)
    p_dD = torch.empty(Bsz, G, nC, D, device=dev)
    p_dconv = torch.empty(Bsz, G, nCT, D, W + 1, device=dev)
    err = _build.library().mamba_fused_bwd(
        xz.data_ptr(), dout.data_ptr(), dxz.data_ptr(), *(t.data_ptr() for t in w),
        state.data_ptr(), dtsum.data_ptr(), gcarry.data_ptr(), dpre.data_ptr(),
        None if xdbl is None else xdbl.data_ptr(),
        p_dxp.data_ptr(), p_ddtw.data_ptr(), p_ddtb.data_ptr(), p_dA.data_ptr(),
        p_dD.data_ptr(), p_dconv.data_ptr(), Bsz, G, D, L, N, R, W, plan["T"], plan["Dc"],
        _CONV_TILE, int(reverse), int(sd == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, f"mamba_fused_bwd at B {Bsz}, G {G}, D {D}, L {L}, N {N}, R {R}, W {W}, "
                      f"T {plan['T']}, {plan['nb']} blocks of {plan['Dc']} channels a chunk")
    mamba_fused_scan.bwd_launches += 1
    dconv = p_dconv.sum((0, 2))  # the host sums over batch and blocks, as core_bwd
    return (dxz, dconv[..., :W], dconv[..., W], p_dxp.sum((0, 2)), p_ddtw.sum((0, 2)),
            p_ddtb.sum((0, 2)), p_dA.sum((0, 2)), p_dD.sum((0, 2)))


class _MambaFusedFn(torch.autograd.Function):
    """The CUDA forward kernel, keeping the chunk-entry states and the sums
    of dt for the CUDA backward kernel. Gradients come back in each input's
    own dtype, as the JAX core_bwd returns them: the stream-dtype weights'
    gradients in that dtype (autograd carries them to the f32 parameters
    through the caller's casts), dt_b, A and D in f32."""

    @staticmethod
    def forward(ctx, xz, conv_w, conv_b, x_proj, dt_w, dt_b, A, D_skip, reverse):
        w = _kernel_operands(xz, conv_w, conv_b, x_proj, dt_w, dt_b, A, D_skip)
        out, state, dtsum = _launch_fwd(xz, w, reverse)
        ctx.reverse = reverse
        ctx.dtypes = [None if t is None else t.dtype
                      for t in (xz, conv_w, conv_b, x_proj, dt_w, dt_b, A, D_skip)]
        ctx.save_for_backward(xz, state, dtsum, *w)
        return out

    @staticmethod
    def backward(ctx, dout):
        xz, state, dtsum, *w = ctx.saved_tensors
        grads = _launch_bwd(dout, xz, w, state, dtsum, ctx.reverse)
        return (*(None if dt is None else g.to(dt) for g, dt in zip(grads, ctx.dtypes)), None)


def mamba_fused_scan(
    xz: torch.Tensor,               # (B, G, 2D, L) packed in_proj output
    conv_w: torch.Tensor,           # (G, D, W)
    conv_b: Optional[torch.Tensor],  # (G, D) or None
    x_proj: torch.Tensor,           # (G, R + 2N, D)
    dt_w: torch.Tensor,             # (G, D, R)
    dt_b: torch.Tensor,             # (G, D)
    A: torch.Tensor,                # (G, D, N), negative
    D_skip: torch.Tensor,           # (G, D)
    reverse: bool = False,
) -> torch.Tensor:
    """(B, G, D, L) gated scan outputs in xz's dtype (f32 or bf16);
    differentiable w.r.t. every tensor input."""
    if xz.device.type == "cpu":
        return mamba_fused_scan_ref(xz, conv_w, conv_b, x_proj, dt_w, dt_b, A, D_skip, reverse)
    if xz.device.type != "cuda":
        raise ValueError(f"mamba_fused_scan: no kernel for device {xz.device}")
    sd, dev = xz.dtype, xz.device
    # the weights the kernels multiply, rounded to the stream dtype here so
    # that their gradients pass through the same casts back to f32
    return _MambaFusedFn.apply(
        xz.contiguous(), conv_w.to(dev).to(sd), None if conv_b is None else conv_b.to(dev).float(),
        x_proj.to(dev).to(sd), dt_w.to(dev).to(sd), dt_b.to(dev).float(), A.to(dev).float(),
        D_skip.to(dev).float(), bool(reverse),
    )


mamba_fused_scan.launches = 0
mamba_fused_scan.bwd_launches = 0
