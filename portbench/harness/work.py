"""The yardstick of operations and bytes.

The kernels' work and least time (`bound`, `mamba_work`, `tap_work`) are
copies of `chip_smoke.py`'s, with the peaks of NVIDIA's data sheet for the
H100 SXM at 700 W: 3.35 TB/s of HBM, 67 TFLOP/s of f32 outside the tensor
cores, 989 TFLOP/s of dense bf16 on them. Each input byte counts once and
each output byte once, whatever a kernel reads again.

`model_flops` counts the products (convolutions and matrix products) of one
forward, or forward and backward, of a configuration's plain reference at a
cell's shapes, with `torch.utils.flop_counter.FlopCounterMode` on the meta
device: the same work whatever implements it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12


def bound(nbytes: float, ops: float, tc_ops: float = 0.0) -> float:
    """Least time in ms for `nbytes` moved, `ops` on the FMA units and
    `tc_ops` on the bf16 tensor cores (the two units run at once)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_OPS_PER_S, tc_ops / BF16_TC_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops)


def mamba_work(B, D, L, N, R, W, es, backward):
    """(bytes, operations) of one fused Mamba scan of one direction: xz and
    the weights in, the gated output out (backward: xz, dout and the
    weights in, dxz and the weights' gradients out); per (b, d, t) the conv,
    projections, softplus and gate, per (b, d, n, t) the scan's exp and
    multiply-adds (the backward: rebuild, local and full adjoint)."""
    E = R + 2 * N
    weights = 4 * (D * W + E * D + D * R + D * N + 3 * D)
    if backward:
        return (es * B * L * 5 * D + 2 * weights,
                B * L * (D * (4 * W + 4 * E + 4 * R + 30) + D * N * 29))
    return es * B * L * 3 * D + weights, B * L * (D * (2 * W + 2 * E + 2 * R + 14) + D * N * 8)


def tap_work(B, H, W, C, F, K, es, backward):
    """(bytes, FMA-unit operations, tensor-core operations) of one tap-conv:
    feat, row coordinates, kernel (in the stream dtype) and bias in, output
    out (backward: feat, rows, kernel and dout in, dfeat, dy, dkernel and
    dbias out, dkernel and dbias f32); per pixel the gathered lerp and the
    (K C) x F product (backward: the lerp, the scatter and dy, and two
    products). A bf16 stream's products run on the tensor cores."""
    px = B * H * W
    if backward:
        nbytes = px * (2 * C * es + 2 * K * 4 + F * es) + K * C * F * (es + 4) + 4 * F
        prod, rest = px * 4 * K * C * F, px * 8 * K * C
    else:
        nbytes = px * (C * es + K * 4 + F * es) + K * C * F * es + 4 * F
        prod, rest = px * 2 * K * C * F, px * 3 * K * C
    return (nbytes, rest, prod) if es == 2 else (nbytes, rest + prod, 0.0)


def least_ms(shapes: dict, es: int, backward: bool) -> dict:
    """{kernel family: least ms of one forward's launches (or their
    backwards)} for `shapes` as a configuration's `kernel_shapes` gives
    them."""
    mamba = sum(n * bound(*mamba_work(B, D, L, N, R, W, es, backward))
                for (B, D, L, N, R, W), n in shapes["mamba_fused"])
    tap = sum(n * bound(*tap_work(B, H, W_, C, F, K, es, backward))
              for (B, H, W_, C, F, K), n in shapes["tap_conv"])
    return {"mamba_fused": mamba, "tap_conv": tap}


def model_flops(reference, cfg: dict, batch: int, size: int, train: bool) -> float:
    """Products of one step (train: forward, loss and backward in training
    mode) or one forward (eval) of the plain reference, on the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = reference.build(cfg)
        x = torch.empty(batch, 3, size, size)
    model.train(train)
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            model(x).float().square().mean().backward()
        else:
            with torch.no_grad():
                model(x)
    return float(counter.get_total_flops())
