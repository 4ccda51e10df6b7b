"""The yardstick of operations and bytes.

The kernels' work and least time (`bound`, `mamba_work`, `tap_work`,
`scan_work`) are copies of `chip_smoke.py`'s, with the peaks of NVIDIA's
data sheet for the H100 SXM at 700 W: 3.35 TB/s of HBM, 67 TFLOP/s of f32
outside the tensor cores, 989 TFLOP/s of dense bf16 on them. Each input
byte counts once and each output byte once, whatever a kernel reads again.
`WORK` prices each hand-written kernel family's launch from its shape, as
a configuration's `kernel_shapes` gives it.

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


def scan_work(B, Dm, L, N, G, es, bes, streams, backward, const_bc=False):
    """(bytes, operations) of one selective scan: the `streams` (u, delta[,
    z]) and B/C in, the output out (backward: the streams, B/C and dout in,
    their gradients out); per (b, d, n, t) the exp and multiply-adds of the
    scan (backward: rebuild, local and full adjoint with three sums over the
    states). The chunk states the kernels keep between passes are their
    design's, not the function's, and are not counted."""
    bc = 2 * 4 * Dm * N if const_bc else 2 * bes * B * G * N * L
    if backward:
        return es * B * Dm * L * (2 * streams + 1) + 2 * bc, B * Dm * L * (30 * N + 20)
    return es * B * Dm * L * (streams + 1) + bc, B * Dm * L * (8 * N + 10)


# family: its work (bound's arguments) for one launch of `shape` at stream
# element size `es`, forward or backward
WORK = {
    # shape (B, D, L, N, R, W)
    "mamba_fused": lambda shape, es, backward: mamba_work(*shape, es, backward),
    # shape (B, H, W, C, F, K)
    "tap_conv": lambda shape, es, backward: tap_work(*shape, es, backward),
    # shape (B, Dm, L, N, G, B/C element size, streams, constant B/C)
    "selective_scan": lambda shape, es, backward: scan_work(*shape[:5], es, *shape[5:7],
                                                            backward, shape[7]),
}


def least_ms(shapes: dict, es: int, backward: bool) -> dict:
    """{kernel family: least ms of `shapes`' launches (or their backwards)}
    for every family in `shapes`, as a configuration's `kernel_shapes`
    gives them."""
    return {fam: sum(n * bound(*WORK[fam](shape, es, backward)) for shape, n in launches)
            for fam, launches in shapes.items()}


def least_ms_per_step(shapes: dict, recomputed: dict, es: int, train: bool) -> dict:
    """{kernel family: least ms of one step}: one forward's launches; a
    training step adds their backwards and the forward work of the launches
    it runs again in its backward (`recomputed`)."""
    least = least_ms(shapes, es, False)
    if not train:
        return least
    back, again = least_ms(shapes, es, True), least_ms(recomputed, es, False)
    return {k: least[k] + back[k] + again.get(k, 0.0) for k in least}


def launches_per_step(shapes: dict, recomputed: dict, train: bool) -> dict:
    """{kernel family: (forward, backward) launches of one step}."""
    out = {}
    for fam, launches in shapes.items():
        fwd = sum(n for _, n in launches)
        again = sum(n for _, n in recomputed.get(fam, ()))
        out[fam] = (fwd + again, fwd) if train else (fwd, 0)
    return out


def model_flops(reference, cfg: dict, batch: int, size: int, train: bool) -> float:
    """Products of one step (train: forward, loss and backward in training
    mode) or one forward (eval) of the plain reference, on the meta device.
    The input is the reference module's `example_input(cfg, batch, size)`
    where it has one (a token model's (batch, size) ids), else an image of
    the configuration's `input.channels` at size x size."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = reference.build(cfg)
        example = getattr(reference, "example_input", None)
        x = (example(cfg, batch, size) if example
             else torch.empty(batch, cfg["input"]["channels"], size, size))
    model.train(train)
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            model(x).float().square().mean().backward()
        else:
            with torch.no_grad():
                model(x)
    return float(counter.get_total_flops())
