"""Smoke run of the PyTorch port on one NVIDIA GPU (the H100 it targets).

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from `mm_unet_tpu_torch/csrc/` (one nvcc
per source, in parallel) and runs, in order (every phase prints its lines;
any failure ends the run non-zero):

1. each forward kernel against its plain PyTorch version on the card, at
   the shapes MM_Net's 512² batch-8 path gives it, in f32 and bf16, forward
   and reverse, with the tolerance stated on the line and both times; then
   each backward kernel against autograd of the plain version at the same
   shapes, every input's gradient compared; then the chunked selective scan
   (forward and backward kernels) through `selective_scan` at dkDualNet's
   three grouped scans (512², batch 8, f32 and bf16, every fused flag), the
   bare scan with its last state and a constant (D, N) B/C, its backward
   against autograd of the plain version at every shape;
2. the full-width MM_Net (f32, seeded init) at 1x3x128x128 with the kernels
   on the card against the plain versions on the CPU, same weights; then
   the gradients of every parameter of an MM_Net with full-width channels
   and depths (1,1,1,1) in train mode, card against CPU;
3. the serving path: full-width MM_Net in bf16 through `make_predictor`,
   512² sliding windows (overlap 0.5) over a synthetic DRIVE-like batch of 8
   and one 704² image, DiceFocal and the shared metrics through
   `val_one_epoch`; checks finite logits and that each kernel was launched
   exactly as often as the model's modules imply; then times sliding-window
   images/s for the f32 and the bf16 predictor;
4. the training path: full-width MM_Net, bf16 feature path, remat off,
   `train_step`s (DiceFocal, backward, AdamW at lr 1e-3) on a synthetic batch
   of 8 at 512²; checks a finite loss at every step, a last loss below the
   first, and each kernel's forward and backward launches per step against
   the modules' counts (and one step with remat on); times train images/s
   and reads the peak device memory; then, as part of phase 1, times the
   fused Mamba backward alone at every shape one of those steps gave it
   (read by forward hooks on the Mambas), with its bound and its launches
   per step (`phase1 mamba_fused_scan_bwd_step` lines);
5. dkDualNet at full width, f32, the same weights on both of its Mambas'
   routes (a: the fused-scan megakernels; b: the grouped selective scan):
   eval logits at 8x3x512² and every parameter gradient of one train-mode
   pass, a against b; then route b on the card against the plain model on
   the CPU for full-width channels at depths (1,1,1,1), every gradient,
   each relative to its own tensor;
6. dkDualNet's path on route b: `val_one_epoch` over 512² sliding windows
   (two batches of 8), images/s for the f32 and bf16 predictor, six
   `train_step`s at 512² batch 8 (finite, falling losses, train images/s,
   peak memory), each with exact launch counts; then three-step blocks on
   routes a, a and b for the two routes' train rates on one card.

The last lines are the card's name and power limit, one JSON line of kernel
numbers (each kernel's time, its plain version's, its bound and its launches
on the paths above), and `{"ok": true, "device": {...}}`. Without a CUDA device it exits
non-zero before printing any result. It imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# a kernel against its plain version, per element: |kernel - plain| <=
# tol * (|plain| + rms(plain)) (`rel_err`), each element held to its own
# size, floored at the tensor's root mean square where sums cancel to near
# zero. f32 differs only by summation order (largest sound reading 4.4e-6,
# the selective scan's backward); bf16 by at most one output ulp (2^-8 to
# 2^-7 relative) where an f32 sum lands on the other side of a rounding
# boundary (largest 6.4e-3). The selective scan's backward rounds each
# gradient once, at its end, as its plain version does: it is held to these
# limits too
TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}
# whole model, kernels on the card vs plain on the CPU, f32: conv libraries
# and sums in other orders through ~100 layers
MODEL_TOL = 2e-3
# the fused Mamba and tap-conv backward kernels vs autograd of their plain
# versions, per input gradient, in the same per-element form: f32 sums over
# chunks, blocks and atomics in other orders (largest sound reading 5.2e-6);
# bf16 rounds the gradients at other points than the plain version's casts,
# a few ulps (largest 3.5e-2, tap-conv's dfeat)
BWD_TOL = {torch.float32: 3e-5, torch.bfloat16: 1e-1}
# every parameter gradient of MM_Net at depth 1 in train mode, card vs CPU,
# f32, relative to 1 + max |CPU|: the forward's differences (summation
# orders, scan chunking) carried back through ~40-60 layers and batch
# statistics over few values per channel at the deepest stage
GRAD_TOL = 1e-2
# dkDualNet, f32: the logits per element as `rel_err`, and every parameter
# gradient relative to the largest |want| of its own tensor (the layer
# scales of 1e-6 leave the blocks' gradients at 1e-11 to 1e-4), route a vs
# route b (largest sound reading 8.5e-6), and route b on the card vs the
# plain model on the CPU (6.2e-5; other convolution libraries)
ROUTE_TOL = 5e-5
DK_CPU_TOL = 3e-4
TRAIN_STEPS = 6
# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): device
# memory bytes/s, and f32 operations/s outside the tensor cores (every
# kernel here runs on the FMA units); a kernel's bound is the larger of its
# bytes (each input read once, each output written once) over the first and
# its operations over the second
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# dkDualNet's three grouped scans at 512², batch 8: (channels per direction,
# tokens) of stages 2, 3 and 4, two directions each, 16 states
DK_SCANS = ((96, 16384), (192, 4096), (384, 1024))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) for `nbytes` moved and `ops` done."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def tap_work(B, HW, C, F, K, es, backward):
    """(bytes, operations) of one tap-conv: feat, row coordinates and kernel
    in, output out (backward: also dout in, dfeat, dy and dkernel out); the
    gathered lerp and the (K C) x F product per pixel (backward: two)."""
    px = B * HW * HW
    if backward:
        return px * (2 * C * es + 2 * K * 4 + F * es) + 8 * K * C * F + 4 * F, px * (4 * K * C * F + 8 * K * C)
    return px * (C * es + K * 4 + F * es) + 4 * (K * C * F + F), px * (2 * K * C * F + 3 * K * C)


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


def mamba_inputs(rn, dev, B, D, R, L, N=16, W=4):
    """xz (B, 1, 2D, L) and the seven weights of one fused Mamba scan, the
    A rows those of Mamba's init (-1 .. -N), in that order from `rn`."""
    xz = torch.cat([rn(B, 1, D, L, scale=0.5), rn(B, 1, D, L)], dim=2)
    w = [rn(1, D, W, scale=0.4), rn(1, D, scale=0.1), rn(1, R + 2 * N, D, scale=D ** -0.5),
         rn(1, D, R, scale=R ** -0.5), rn(1, D, scale=0.1) - 4.0,
         -torch.exp(torch.log(torch.arange(1, N + 1.0, device=dev)).repeat(1, D, 1)),
         torch.ones(1, D, device=dev)]
    return xz, w


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() in ms over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| / (|want| + rms(want))) over
    the elements."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    floor = w.square().mean().sqrt()
    rel = diff / (w.abs() + floor).clamp_min(torch.finfo(torch.float32).tiny)
    return diff.max().item(), rel.max().item()


def compare(got, want, dtype):
    err, rel = rel_err(got, want)
    return err, rel, rel <= TOL[dtype]


def phase1_kernels(gen) -> dict:
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan, mamba_fused_scan_ref
    from mm_unet_tpu_torch.ops.tap_conv import tap_conv, tap_conv_ref

    dev = torch.device("cuda")

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

    results = {"mamba_fused_scan": [], "tap_conv": []}
    failed = []
    # Mamba: RCG3 (d_model 64 -> D=128, R=4, L=128²) and the Side2 MMConv
    # (d_model 3 -> D=6, R=1, L=256²), batch 2, N=16, W=4
    for D, R, L in ((128, 4, 16384), (6, 1, 65536)):
        N, W, B = 16, 4, 2
        xz, w = mamba_inputs(rn, dev, B, D, R, L, N, W)
        for dtype in (torch.float32, torch.bfloat16):
            x = xz.to(dtype)
            for rev in (False, True):
                got = mamba_fused_scan(x, *w, reverse=rev)
                torch.cuda.synchronize()
                want = mamba_fused_scan_ref(x, *w, reverse=rev)
                torch.cuda.synchronize()
                err, rel, ok = compare(got, want, dtype)
                ms = cuda_ms(lambda: mamba_fused_scan(x, *w, reverse=rev), reps=20)
                plain_ms = cuda_ms(lambda: mamba_fused_scan_ref(x, *w, reverse=rev), reps=1)
                bms, by = bound(*mamba_work(B, D, L, N, R, W, x.element_size(), False))
                rec = dict(D=D, L=L, B=B, dtype=str(dtype)[6:], reverse=rev, max_abs_err=err,
                           rel_err=rel, tol=TOL[dtype], ms=ms, plain_ms=plain_ms, bound_ms=bms,
                           bound_by=by, ok=ok)
                print(f"phase1 mamba_fused_scan {json.dumps(rec)}", flush=True)
                results["mamba_fused_scan"].append(rec)
                failed += [] if ok else [rec]
                del got, want
        del xz, x
    # tap-conv at 512² batch 8: stage-2 MMConv (128², C=F=64), stage 5
    # (16², C=F=512), a side output at 256² (C=64, F=16), a 1x1 reducer
    # (64², C=128, F=64, K=1)
    for hw, C, F, K in ((128, 64, 64, 3), (16, 512, 512, 3), (256, 64, 16, 3), (64, 128, 64, 1)):
        B = 8
        feat = rn(B, hw, hw, C)
        rows = torch.arange(hw, dtype=torch.float32, device=dev)[None, :, None, None]
        y = rows + rn(B, hw, hw, K, scale=2.0)  # reaches past both edges
        ker, bias = rn(K, 1, C, F, scale=(K * C) ** -0.5), rn(F, scale=0.1)
        shifts = [j - K // 2 for j in range(K)]
        for dtype in (torch.float32, torch.bfloat16):
            f = feat.to(dtype)
            got = tap_conv(f, y, ker, bias, shifts)
            torch.cuda.synchronize()
            want = tap_conv_ref(f, y, ker, bias, shifts)
            torch.cuda.synchronize()
            err, rel, ok = compare(got, want, dtype)
            ms = cuda_ms(lambda: tap_conv(f, y, ker, bias, shifts), reps=20)
            plain_ms = cuda_ms(lambda: tap_conv_ref(f, y, ker, bias, shifts), reps=5)
            bms, by = bound(*tap_work(B, hw, C, F, K, f.element_size(), False))
            rec = dict(HW=hw, C=C, F=F, K=K, B=B, dtype=str(dtype)[6:], max_abs_err=err,
                       rel_err=rel, tol=TOL[dtype], ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, ok=ok)
            print(f"phase1 tap_conv {json.dumps(rec)}", flush=True)
            results["tap_conv"].append(rec)
            failed += [] if ok else [rec]
    if failed:
        raise SystemExit(f"phase1 FAILED: {len(failed)} kernel comparisons out of tolerance")
    return results


def grads_of(fn, inputs, dout):
    """(out, the inputs that take gradients, their gradients) of fn at
    copies of `inputs`; the graph is kept so that the backward can be timed."""
    ins = [None if t is None else t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    live = [t for t in ins if t is not None]
    return out, live, torch.autograd.grad(out, live, dout, retain_graph=True)


def compare_grads(got, want, names, tol):
    """({name: [max_abs_err, rel_err]}, all within `tol`) per gradient."""
    errs = {name: list(rel_err(g, w)) for name, g, w in zip(names, got, want)}
    return errs, all(rel <= tol for _, rel in errs.values())


def grad_errs(got: dict, want: dict) -> tuple[int, list]:
    """(parameters out of GRAD_TOL or not finite, the four worst) for two
    {name: gradient} maps, each error relative to 1 + max |want|."""
    worst, bad = [], 0
    for name, w in want.items():
        g = got[name]
        err = (g.float().cpu() - w.float().cpu()).abs().max().item()
        rel = err / (1.0 + w.float().abs().max().item())
        worst.append((rel, name, err))
        bad += rel > GRAD_TOL or not bool(torch.isfinite(g).all())
    worst.sort(reverse=True)
    return bad, [dict(name=n, max_abs_err=e, relative=r) for r, n, e in worst[:4]]


def bn_fed_biases(model: torch.nn.Module) -> set:
    """Names of the conv biases that feed a BatchNorm directly (within an
    nn.Sequential): in train mode the norm subtracts the batch mean, so
    their gradient is zero in exact arithmetic and rounding noise in f32."""
    names = set()
    for prefix, m in model.named_modules():
        if isinstance(m, torch.nn.Sequential):
            for i, (conv, norm) in enumerate(zip(m, list(m)[1:])):
                if (isinstance(conv, torch.nn.Conv2d) and conv.bias is not None
                        and isinstance(norm, torch.nn.BatchNorm2d)):
                    names.add(f"{prefix}.{i}.bias" if prefix else f"{i}.bias")
    return names


def tensor_grad_errs(got: dict, want: dict, tol: float, exact_zero: set) -> tuple[int, list]:
    """(parameters out of `tol` or not finite, the four worst) for two
    {name: gradient} maps, each error relative to the largest |want| of its
    own tensor. A gradient that is zero in exact arithmetic (`exact_zero`)
    is held to zero instead: its largest |got| and |want| relative to the
    largest gradient of the model."""
    top = max(w.float().abs().max().item() for w in want.values())
    worst, bad = [], 0
    for name, w in want.items():
        g, w = got[name].float().cpu(), w.float().cpu()
        if name in exact_zero:
            err, size = max(g.abs().max().item(), w.abs().max().item()), top
        else:
            err, size = (g - w).abs().max().item(), w.abs().max().item()
        rel = err / size if size else (math.inf if err else 0.0)
        worst.append((rel, name, err, size))
        bad += not rel <= tol or not bool(torch.isfinite(g).all())
    worst.sort(reverse=True)
    return bad, [dict(name=n, max_abs_err=e, relative=r, scale=m) for r, n, e, m in worst[:4]]


SERVING_REPS = 10
SERVING_PASSES = 2 * (1 + SERVING_REPS)  # per `serving_rates` call: two predictors


def serving_rates(model, inferer, x) -> dict:
    """Sliding-window images/s of the f32 and the bf16 predictor over
    SERVING_REPS passes each, after one warm-up pass each."""
    from mm_unet_tpu_torch.train.predictor import make_predictor

    rates = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        predictor = make_predictor(model, dtype)
        inferer(x, predictor)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVING_REPS):
            out = inferer(x, predictor)
        torch.cuda.synchronize()
        rates[name] = x.shape[0] * SERVING_REPS / (time.perf_counter() - t0)
        if not bool(torch.isfinite(out).all()):
            raise SystemExit(f"FAILED: non-finite {name} logits")
    return rates


def phase1_backward(gen) -> dict:
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan, mamba_fused_scan_ref
    from mm_unet_tpu_torch.ops.tap_conv import tap_conv, tap_conv_ref

    dev = torch.device("cuda")

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

    results = {"mamba_fused_scan_bwd": [], "tap_conv_bwd": []}
    failed = []

    def run(kind, shape, fn, ref, inputs, dout, names, dtype, plain_reps, work):
        out, live, got = grads_of(fn, inputs, dout)
        torch.cuda.synchronize()
        outp, livep, want = grads_of(ref, inputs, dout)
        torch.cuda.synchronize()
        errs, ok = compare_grads(got, want, names, BWD_TOL[dtype])
        ms = cuda_ms(lambda: torch.autograd.grad(out, live, dout, retain_graph=True), reps=10)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(outp, livep, dout, retain_graph=True),
                           reps=plain_reps, warmup=0)
        bms, by = bound(*work)
        rec = dict(shape, dtype=str(dtype)[6:], max_abs_err=max(e for e, _ in errs.values()),
                   rel_err=max(r for _, r in errs.values()), tol=BWD_TOL[dtype], errs=errs,
                   ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, ok=ok)
        print(f"phase1 {kind} {json.dumps(rec)}", flush=True)
        results[kind].append(rec)
        failed.extend([] if ok else [rec])

    # the same shapes as the forward comparison
    for D, R, L in ((128, 4, 16384), (6, 1, 65536)):
        N, W, B = 16, 4, 2
        xz, w = mamba_inputs(rn, dev, B, D, R, L, N, W)
        dout = rn(B, 1, D, L)
        names = ["xz", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b", "A", "D"]
        for dtype in (torch.float32, torch.bfloat16):
            for rev in (False, True):
                run("mamba_fused_scan_bwd", dict(D=D, L=L, B=B, reverse=rev),
                    lambda *a, r=rev: mamba_fused_scan(*a, reverse=r),
                    lambda *a, r=rev: mamba_fused_scan_ref(*a, reverse=r),
                    [xz.to(dtype), *w], dout.to(dtype), names, dtype, plain_reps=1,
                    work=mamba_work(B, D, L, N, R, W, dout.to(dtype).element_size(), True))
        del xz, dout
    for hw, C, F, K in ((128, 64, 64, 3), (16, 512, 512, 3), (256, 64, 16, 3), (64, 128, 64, 1)):
        B = 8
        rows = torch.arange(hw, dtype=torch.float32, device=dev)[None, :, None, None]
        inputs = [rn(B, hw, hw, C), rows + rn(B, hw, hw, K, scale=2.0),
                  rn(K, 1, C, F, scale=(K * C) ** -0.5), rn(F, scale=0.1)]
        dout = rn(B, hw, hw, F)
        shifts = [j - K // 2 for j in range(K)]
        for dtype in (torch.float32, torch.bfloat16):
            run("tap_conv_bwd", dict(HW=hw, C=C, F=F, K=K, B=B),
                lambda *a: tap_conv(*a, shifts), lambda *a: tap_conv_ref(*a, shifts),
                [inputs[0].to(dtype), *inputs[1:]], dout.to(dtype),
                ["feat", "y", "kernel", "bias"], dtype, plain_reps=3,
                work=tap_work(B, hw, C, F, K, dout.to(dtype).element_size(), True))
    if failed:
        raise SystemExit(f"phase1 FAILED: {len(failed)} backward comparisons out of tolerance")
    return results


def mamba_step_shapes(model) -> tuple[dict, list]:
    """({shape: fused-scan calls}, hooks): forward hooks on the model's
    megakernel Mambas that count, per forward, one call per direction at
    (batch, d_inner, dt_rank, d_state, conv width, tokens, reverse, stream
    dtype); a train step's backward launches kernel 2 once per call."""
    from mm_unet_tpu_torch.models.mamba import DIRECTIONS, Mamba

    shapes: dict = {}

    def record(mod, inputs, _):
        bsz, length, _ = inputs[0].shape
        dtype = str(mod.dtype or inputs[0].dtype)[6:]
        for sfx in DIRECTIONS[mod.bimamba_type]:
            key = (bsz, mod.d_inner, mod.dt_rank, mod.d_state, mod.conv1d.weight.shape[-1],
                   length, sfx == "_b", dtype)
            shapes[key] = shapes.get(key, 0) + 1

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, Mamba) and m.use_mega]
    return shapes, hooks


def kernel_device_ms(fn, fragment: str, reps: int = 3) -> float:
    """Device time of one call of fn() (already warm) spent in the kernels
    whose names contain `fragment`, each launched once per call, by
    torch.profiler over `reps` calls: without the host's share, which
    decides `cuda_ms` at small shapes. Each kernel's time is its mean over
    the launches the profiler recorded, which need not be all of them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and fragment in e.key) / 1e3


def phase1_step_shapes(shapes: dict, seed: int) -> list:
    """Kernel 2 alone at every shape that a train step gives it (from
    `mamba_step_shapes`): `torch.autograd.grad` through `mamba_fused_scan`,
    mean of 3 calls after one (`ms`, CUDA events, host included), and the
    device time of its kernels in 3 more (`kernel_ms`); random inputs made
    on the card. Timing only: the comparisons are phase 1's."""
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan

    dev = torch.device("cuda")
    cgen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=cgen, device=dev) * scale

    recs = []
    for (B, D, R, N, W, L, rev, dt), calls in sorted(shapes.items()):
        dtype = getattr(torch, dt)
        xz, w = mamba_inputs(rn, dev, B, D, R, L, N, W)
        dout = rn(B, 1, D, L).to(dtype)
        out, live, _ = grads_of(lambda *a: mamba_fused_scan(*a, reverse=rev),
                                [xz.to(dtype), *w], dout)
        call = lambda: torch.autograd.grad(out, live, dout, retain_graph=True)  # noqa: E731
        ms = cuda_ms(call, reps=3)
        bms, by = bound(*mamba_work(B, D, L, N, R, W, dout.element_size(), True))
        rec = dict(B=B, D=D, R=R, N=N, W=W, L=L, reverse=rev, dtype=dt, ms=ms,
                   kernel_ms=kernel_device_ms(call, "mamba_bwd_"), bound_ms=bms, bound_by=by,
                   launches_per_step=calls)
        print(f"phase1 mamba_fused_scan_bwd_step {json.dumps(rec)}", flush=True)
        recs.append(rec)
        del xz, w, dout, out, live
    return recs


def phase1_scan(gen) -> dict:
    """The chunked selective scan (kernels 5-8 of the TPU package) through
    the `selective_scan` entry point against its plain version on the card:
    dkDualNet's three grouped scans at 512² batch 8 with every fused flag on,
    B/C the views of x_dbl that the Mamba passes, in f32 and bf16; the bare
    scan (no bias, softplus, D or z) with its last state, B/C (B, N, L); a
    constant (D, N) B/C. The forward, and the backward against autograd of
    the plain version, every input's gradient, at every shape."""
    import torch.nn.functional as F

    from mm_unet_tpu_torch.ops.selective_scan import selective_scan, selective_scan_ref

    dev = torch.device("cuda")

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

    results = {"selective_scan": [], "selective_scan_bwd": []}
    failed = []
    B, N = 8, 16
    names = ["u", "delta", "A", "B", "C", "D", "z", "delta_bias"]
    cases = [("fused", dg, 2, L) for dg, L in DK_SCANS] + [("bare", 384, 1, 4096),
                                                         ("const", 384, 1, 4096)]
    for kind, dg, G, L in cases:
        dm, fused = dg * G, kind != "bare"
        R = -(-dg // 32)  # the dkDualNet Mamba's dt_rank: ceil(d_model / 16), d_model = dg / 2
        u, z = rn(B, dm, L), rn(B, dm, L)
        delta = rn(B, dm, L, scale=0.5) if fused else F.softplus(rn(B, dm, L, scale=0.5) - 4.0)
        A = -torch.exp(torch.log(torch.arange(1, N + 1.0, device=dev)).repeat(dm, 1))
        D, bias = rn(dm, scale=0.5) + 1.0, rn(dm, scale=0.1) - 4.0
        x_dbl = rn(B, G, R + 2 * N, L) if kind == "fused" else None
        bc = (rn(dm, N), rn(dm, N)) if kind == "const" else (rn(B, N, L), rn(B, N, L))
        dout = rn(B, dm, L)
        for dtype in ((torch.float32, torch.bfloat16) if kind == "fused" else (torch.float32,)):
            if kind == "fused":
                xd = x_dbl.to(dtype)
                Bm, Cm = xd[:, :, R:R + N], xd[:, :, R + N:]
            elif kind == "bare":
                Bm, Cm = bc[0].to(dtype), bc[1].to(dtype)
            else:
                Bm, Cm = bc
            args = [u.to(dtype), delta.to(dtype), A, Bm, Cm] + (
                [D, z.to(dtype), bias] if fused else [None, None, None])

            def call(fn, *a):
                a = a or args
                res = fn(*a[:5], D=a[5], z=a[6], delta_bias=a[7], delta_softplus=fused,
                         return_last_state=not fused)
                return res if fused else res[0]

            with torch.no_grad():
                got = selective_scan(*args[:5], D=args[5], z=args[6], delta_bias=args[7],
                                     delta_softplus=fused, return_last_state=not fused)
                want = selective_scan_ref(*args[:5], D=args[5], z=args[6], delta_bias=args[7],
                                          delta_softplus=fused, return_last_state=not fused)
                torch.cuda.synchronize()
                got, got_last = (got, None) if fused else got
                want, want_last = (want, None) if fused else want
                err, rel, ok = compare(got, want, dtype)
                last = {}
                if not fused:  # the last state, f32
                    e2, r2, ok2 = compare(got_last, want_last, torch.float32)
                    ok = ok and ok2
                    last = dict(last_state_err=e2, last_state_rel_err=r2)
                ms = cuda_ms(lambda: call(selective_scan), reps=20)
                plain_ms = cuda_ms(lambda: call(selective_scan_ref), reps=1, warmup=0)
            es, bes = args[0].element_size(), Bm.element_size()
            streams = 3 if fused else 2
            g = dm if kind == "const" else G
            shape = dict(kind=kind, G=G, D_per_group=dg, L=L, B=B, dtype=str(dtype)[6:])
            bms, by = bound(*scan_work(B, dm, L, N, g, es, bes, streams, False, kind == "const"))
            rec = dict(shape, max_abs_err=err, rel_err=rel, tol=TOL[dtype], **last, ms=ms,
                       plain_ms=plain_ms, bound_ms=bms, bound_by=by, ok=ok)
            print(f"phase1 selective_scan {json.dumps(rec)}", flush=True)
            results["selective_scan"].append(rec)
            failed += [] if ok else [rec]
            del got, want

            d_out = dout.to(dtype)
            out, live, got_g = grads_of(lambda *a: call(selective_scan, *a), args, d_out)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: torch.autograd.grad(out, live, d_out, retain_graph=True), reps=10)
            bms, by = bound(*scan_work(B, dm, L, N, g, es, bes, streams, True, kind == "const"))
            outp, livep, want_g = grads_of(lambda *a: call(selective_scan_ref, *a), args, d_out)
            torch.cuda.synchronize()
            live_names = [nm for nm, t in zip(names, args) if t is not None]
            errs, ok = compare_grads(got_g, want_g, live_names, TOL[dtype])
            plain_ms = cuda_ms(lambda: torch.autograd.grad(outp, livep, d_out, retain_graph=True),
                               reps=1, warmup=0)
            rec = dict(shape, max_abs_err=max(e for e, _ in errs.values()),
                       rel_err=max(r for _, r in errs.values()), tol=TOL[dtype], errs=errs,
                       ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, ok=ok)
            failed += [] if ok else [rec]
            del outp, livep, want_g
            print(f"phase1 selective_scan_bwd {json.dumps(rec)}", flush=True)
            results["selective_scan_bwd"].append(rec)
            del out, live, got_g
    if failed:
        raise SystemExit(f"phase1 FAILED: {len(failed)} selective-scan comparisons out of tolerance")
    return results


def phase2_model(seed: int) -> None:
    from mm_unet_tpu_torch.models import give_model

    cpu_model = give_model("MM_Net", device="cpu", generator=torch.Generator().manual_seed(seed),
                           mamba_dtype=None)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((1, 3, 128, 128),
                                                                      np.float32))
    t0 = time.perf_counter()
    with torch.inference_mode():
        got = gpu_model(x.cuda())
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        want = cpu_model(x)
    t_cpu = time.perf_counter() - t0 - t_gpu
    err = (got.cpu() - want).abs().max().item()
    scale = 1.0 + want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= MODEL_TOL * scale
    print("phase2 " + json.dumps(dict(shape=list(got.shape), max_abs_err=err,
                                      tol=MODEL_TOL * scale, gpu_s=t_gpu, cpu_s=t_cpu, ok=ok)),
          flush=True)
    if not ok:
        raise SystemExit("phase2 FAILED: kernel model disagrees with the plain model")


def phase2_gradients(seed: int) -> None:
    """Every parameter gradient of one train-mode forward and backward, the
    kernels on the card against the plain versions on the CPU (whose scan
    walks tokens one by one, hence the small depth and input)."""
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.train.losses import dice_focal_loss

    cpu_model = give_model("MM_Net", device="cpu", generator=torch.Generator().manual_seed(seed),
                           mamba_dtype=None, depths=(1, 1, 1, 1), num_slices_list=(4, 4, 4, 4),
                           remat=False, sideout_drop=0.0).train()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 1, 64, 64)) < 0.2).astype(np.float32))
    t0 = time.perf_counter()
    dice_focal_loss(gpu_model(x.cuda()), y.cuda()).backward()
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    dice_focal_loss(cpu_model(x), y).backward()
    t_cpu = time.perf_counter() - t0 - t_gpu
    want = {k: p.grad for k, p in cpu_model.named_parameters()}
    bad, worst = grad_errs({k: p.grad for k, p in gpu_model.named_parameters()}, want)
    ok = bad == 0
    print("phase2 gradients " + json.dumps(dict(
        params=len(want), out_of_tol=bad, tol_relative=GRAD_TOL, worst=worst,
        gpu_s=t_gpu, cpu_s=t_cpu, ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase2 FAILED: card gradients disagree with the plain model's")


def phase3_serving(seed: int, profile: bool = False) -> dict:
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.evaluate import val_one_epoch
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan
    from mm_unet_tpu_torch.ops.tap_conv import tap_conv
    from mm_unet_tpu_torch.train.inferers import SlidingWindowInferer
    from mm_unet_tpu_torch.train.losses import dice_focal_loss
    from mm_unet_tpu_torch.train.metrics import build_metrics
    from mm_unet_tpu_torch.train.predictor import make_predictor

    model = give_model("MM_Net", device="cuda", generator=torch.Generator().manual_seed(seed))
    per_forward = model.kernel_launches_per_forward()
    batches = [synthetic_batch(8, 512, seed), synthetic_batch(1, 704, seed + 1)]
    inferer = SlidingWindowInferer(roi_size=(512, 512), overlap=0.5)
    logits = []

    def infer(images, predictor):
        out = inferer(images, predictor)
        logits.append(out)
        return out

    # 512² batch 8: 8 windows in one group; 704²: 4 windows in one group
    forwards = 2
    mamba_fused_scan.launches = tap_conv.launches = 0
    t0 = time.perf_counter()
    f1, metric, losses = val_one_epoch(model, dice_focal_loss, infer, batches, build_metrics())
    torch.cuda.synchronize()
    t_val = time.perf_counter() - t0
    launches = {"mamba_fused_scan": mamba_fused_scan.launches, "tap_conv": tap_conv.launches}
    expect = {k: v * forwards for k, v in per_forward.items()}
    shapes = [list(x.shape) for x in logits]
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    ok = (finite and launches == expect and shapes == [[8, 1, 512, 512], [1, 1, 704, 704]]
          and all(np.isfinite(losses)))
    print("phase3 val " + json.dumps(dict(
        logits=shapes, finite=finite, losses=losses, launches=launches, expected=expect,
        metrics={k: (v if v == v else None) for k, v in metric.items()}, seconds=t_val,
        ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase3 FAILED: serving path")

    x = torch.from_numpy(batches[0]["image"]).cuda()
    rates = serving_rates(model, inferer, x)
    print("phase3 throughput " + json.dumps(dict(
        roi=512, batch=8, overlap=0.5, images_per_sec_f32_predictor=rates["f32"],
        images_per_sec_bf16_predictor=rates["bf16"], card=smi())), flush=True)
    if profile:
        predictor = make_predictor(model, torch.bfloat16)
        profile_step("serve", lambda: inferer(x, predictor))
    return launches


def phase4_training(seed: int, profile: bool = False) -> tuple[dict, dict]:
    """Train steps of the full-width bf16 MM_Net at 512² batch 8. Returns
    each kernel's launches over the run (forward and backward) and the
    fused scans' shapes in one step (`mamba_step_shapes`)."""
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan
    from mm_unet_tpu_torch.ops.tap_conv import tap_conv
    from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn, train_step

    model = give_model("MM_Net", device="cuda", generator=torch.Generator().manual_seed(seed),
                       remat=False)
    batch = synthetic_batch(8, 512, seed + 2)
    x, y = torch.from_numpy(batch["image"]).cuda(), torch.from_numpy(batch["label"]).cuda()
    # lr 1e-3 held constant: warmup 1 epoch of a million steps
    config = {"trainer": dict(lr=1e-3, warmup=1, num_epochs=2, steps_per_epoch=10**6,
                              weight_decay=0.05, optimizer="adamw")}
    state = create_train_state(model, config, seed=seed)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    counters = ((mamba_fused_scan, "mamba_fused_scan"), (tap_conv, "tap_conv"))

    def step():
        for fn, _ in counters:
            fn.launches = fn.bwd_launches = 0
        t0 = time.perf_counter()
        scalars, _ = train_step(state, x, y, loss_fn)
        loss = float(scalars["total_loss"])  # waits for the step
        dt = time.perf_counter() - t0
        got = {name: {"fwd": fn.launches, "bwd": fn.bwd_launches} for fn, name in counters}
        return loss, dt, got

    totals = {"mamba_fused_scan": 0, "mamba_fused_scan_bwd": 0, "tap_conv": 0, "tap_conv_bwd": 0}
    expect = model.kernel_launches_per_train_step()
    torch.cuda.reset_peak_memory_stats()
    losses, times, counts_ok = [], [], True
    shapes, hooks = mamba_step_shapes(model)
    for i in range(TRAIN_STEPS):
        loss, dt, got = step()
        if i == 0:  # the shapes of one step
            for h in hooks:
                h.remove()
        losses.append(loss)
        times.append(dt)
        counts_ok = counts_ok and got == expect
        for name, c in got.items():
            totals[name] += c["fwd"]
            totals[name + "_bwd"] += c["bwd"]
    peak = torch.cuda.max_memory_allocated()
    rate = x.shape[0] * (TRAIN_STEPS - 1) / sum(times[1:])  # the first step warms up
    model.remat = True
    loss_r, dt_r, got_r = step()
    expect_r = model.kernel_launches_per_train_step()
    shapes_ok = sum(shapes.values()) == expect["mamba_fused_scan"]["bwd"]
    ok = (all(np.isfinite(losses)) and np.isfinite(loss_r) and losses[-1] < losses[0]
          and counts_ok and got_r == expect_r and state.step == TRAIN_STEPS + 1 and shapes_ok)
    print("phase4 train " + json.dumps(dict(
        batch=8, size=512, dtype="bfloat16", losses=losses, launches_per_step=expect,
        mamba_shapes=len(shapes), mamba_shapes_cover_launches=shapes_ok,
        counts_ok=counts_ok, remat_step=dict(loss=loss_r, seconds=dt_r, launches=got_r,
                                             expected=expect_r),
        step_seconds=times, train_images_per_sec=rate, max_memory_allocated_bytes=peak,
        card=smi(), ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase4 FAILED: training path")
    if profile:
        model.remat = False
        profile_step("train", lambda: train_step(state, x, y, loss_fn))
    return totals, shapes


def phase5_dkdualnet(seed: int) -> None:
    """dkDualNet at full width (dims 48/96/192/384, depths 2/2/2/2), f32, the
    same weights on both of its Mambas' routes: route a (the megakernels,
    kernels 1/2) against route b (the grouped selective scan, kernels 5/6),
    eval logits at 8x3x512², then one train-mode forward and backward
    (drop_path_rate 0) with every parameter gradient; then route b on the
    card against the plain model on the CPU for full-width channels with
    depths (1,1,1,1) at 2x3x64², every parameter gradient. Both are printed
    before either failure ends the run."""
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.train.losses import dice_focal_loss

    model = give_model("dkDualNet", device="cuda", generator=torch.Generator().manual_seed(seed),
                       drop_path_rate=0.0)
    batch = synthetic_batch(8, 512, seed + 3)
    x, y = torch.from_numpy(batch["image"]).cuda(), torch.from_numpy(batch["label"]).cuda()
    routes = (("a", None), ("b", "pallas"))
    logits, grads, secs = {}, {}, {}
    for route, impl in routes:  # eval first: a train pass moves the running statistics
        model.scan_impl = impl
        with torch.inference_mode():
            logits[route] = model.eval()(x)
    for route, impl in routes:
        model.scan_impl = impl
        model.train().zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        dice_focal_loss(model(x), y).backward()
        torch.cuda.synchronize()
        secs[route] = time.perf_counter() - t0
        grads[route] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    err, rel = rel_err(logits["b"], logits["a"])
    bad, worst = tensor_grad_errs(grads["b"], grads["a"], ROUTE_TOL, bn_fed_biases(model))
    routes_ok = bool(torch.isfinite(logits["b"]).all()) and rel <= ROUTE_TOL and bad == 0
    print("phase5 routes " + json.dumps(dict(
        shape=list(logits["a"].shape), logits_max_abs_err=err, logits_rel_err=rel,
        params=len(grads["a"]), grads_out_of_tol=bad, tol_relative=ROUTE_TOL, worst=worst,
        train_pass_seconds=secs, ok=routes_ok)), flush=True)
    del model, logits, grads

    cpu_model = give_model("dkDualNet", device="cpu", generator=torch.Generator().manual_seed(seed),
                           depths=(1, 1, 1, 1), drop_path_rate=0.0, scan_impl="pallas").train()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 1, 64, 64)) < 0.2).astype(np.float32))
    t0 = time.perf_counter()
    dice_focal_loss(gpu_model(x.cuda()), y.cuda()).backward()
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    dice_focal_loss(cpu_model(x), y).backward()
    t_cpu = time.perf_counter() - t0 - t_gpu
    bad, worst = tensor_grad_errs({k: p.grad for k, p in gpu_model.named_parameters()},
                                  {k: p.grad for k, p in cpu_model.named_parameters()},
                                  DK_CPU_TOL, bn_fed_biases(cpu_model))
    print("phase5 gradients " + json.dumps(dict(
        params=sum(1 for _ in cpu_model.parameters()), out_of_tol=bad,
        tol_relative=DK_CPU_TOL, worst=worst, gpu_s=t_gpu, cpu_s=t_cpu, ok=bad == 0)),
        flush=True)
    if not routes_ok:
        raise SystemExit("phase5 FAILED: dkDualNet's two routes disagree")
    if bad:
        raise SystemExit("phase5 FAILED: dkDualNet's card gradients disagree with the plain model's")


def phase6_dkdualnet_path(seed: int, profile: bool = False) -> dict:
    """dkDualNet's path on route b (the grouped selective scan), each part
    with exact launch counts: the serving path (`val_one_epoch` over 512²
    sliding windows, overlap 0.5, two synthetic batches of 8; then images/s
    for the f32 and the bf16 predictor) and the training path (six
    `train_step`s, DiceFocal, AdamW lr 1e-3, 512² batch 8, f32: finite and
    falling losses, train images/s, peak memory). Then blocks of three train
    steps on route a, route a and route b, after the checked route-b steps,
    so that the two routes' rates are read in turns on one card. Returns the
    launches of each kernel on each path."""
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.evaluate import val_one_epoch
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.ops.chunked_scan import selective_scan_chunked
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan
    from mm_unet_tpu_torch.train.inferers import SlidingWindowInferer
    from mm_unet_tpu_torch.train.losses import dice_focal_loss
    from mm_unet_tpu_torch.train.metrics import build_metrics
    from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn, train_step

    counters = ((selective_scan_chunked, "selective_scan"), (mamba_fused_scan, "mamba_fused_scan"))

    def reset():
        for fn, _ in counters:
            fn.launches = fn.bwd_launches = 0

    def read():
        return {name: {"fwd": fn.launches, "bwd": fn.bwd_launches} for fn, name in counters}

    def expected(per_step: dict, times: int = 1) -> dict:
        out = {name: {"fwd": 0, "bwd": 0} for _, name in counters}
        for name, c in per_step.items():
            out[name] = {k: v * times for k, v in c.items()}
        return out

    model = give_model("dkDualNet", device="cuda", generator=torch.Generator().manual_seed(seed),
                       scan_impl="pallas")
    per_forward = {k: {"fwd": v, "bwd": 0} for k, v in model.kernel_launches_per_forward().items()}
    batches = [synthetic_batch(8, 512, seed + 4), synthetic_batch(8, 512, seed + 5)]
    inferer = SlidingWindowInferer(roi_size=(512, 512), overlap=0.5)
    logits = []

    def infer(images, predictor):
        out = inferer(images, predictor)
        logits.append(out)
        return out

    reset()
    t0 = time.perf_counter()
    f1, metric, losses = val_one_epoch(model, dice_focal_loss, infer, batches, build_metrics())
    torch.cuda.synchronize()
    t_val = time.perf_counter() - t0
    got = read()
    want = expected(per_forward, len(batches))  # one forward per batch of eight windows
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    shapes = [list(x.shape) for x in logits]
    ok = finite and got == want and shapes == [[8, 1, 512, 512]] * 2 and all(np.isfinite(losses))
    print("phase6 val " + json.dumps(dict(
        route="b", logits=shapes, finite=finite, losses=losses, launches=got, expected=want,
        metrics={k: (v if v == v else None) for k, v in metric.items()}, seconds=t_val,
        ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase6 FAILED: dkDualNet serving path")
    serve = {"selective_scan": got["selective_scan"]["fwd"], "selective_scan_bwd": 0}

    x = torch.from_numpy(batches[0]["image"]).cuda()
    reset()
    rates = serving_rates(model, inferer, x)
    if read() != expected(per_forward, SERVING_PASSES):
        raise SystemExit(f"phase6 FAILED: serving launches {read()}")
    print("phase6 throughput " + json.dumps(dict(
        route="b", roi=512, batch=8, overlap=0.5, images_per_sec_f32_predictor=rates["f32"],
        images_per_sec_bf16_predictor=rates["bf16"], card=smi())), flush=True)

    batch = synthetic_batch(8, 512, seed + 2)
    x, y = torch.from_numpy(batch["image"]).cuda(), torch.from_numpy(batch["label"]).cuda()
    config = {"trainer": dict(lr=1e-3, warmup=1, num_epochs=2, steps_per_epoch=10**6,
                              weight_decay=0.05, optimizer="adamw")}
    state = create_train_state(model, config, seed=seed)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})

    def steps(n):
        losses, times, counts_ok = [], [], True
        want = expected(model.kernel_launches_per_train_step())
        for _ in range(n):
            reset()
            t0 = time.perf_counter()
            scalars, _ = train_step(state, x, y, loss_fn)
            losses.append(float(scalars["total_loss"]))  # waits for the step
            times.append(time.perf_counter() - t0)
            counts_ok = counts_ok and read() == want
        return losses, times, counts_ok

    torch.cuda.reset_peak_memory_stats()
    reset()
    train_counts = {"selective_scan": 0, "selective_scan_bwd": 0}
    losses, times, counts_ok = [], [], True
    for _ in range(TRAIN_STEPS):
        lo, ti, ok1 = steps(1)
        losses += lo
        times += ti
        counts_ok = counts_ok and ok1
        train_counts["selective_scan"] += selective_scan_chunked.launches
        train_counts["selective_scan_bwd"] += selective_scan_chunked.bwd_launches
    peak = torch.cuda.max_memory_allocated()
    rate = x.shape[0] * (TRAIN_STEPS - 1) / sum(times[1:])  # the first step warms up
    blocks = []
    for route, impl in (("a", None), ("a", None), ("b", "pallas")):
        model.scan_impl = impl
        lo, ti, ok1 = steps(3)
        counts_ok = counts_ok and ok1
        blocks.append(dict(route=route, losses=lo, step_seconds=ti,
                           train_images_per_sec=x.shape[0] * len(ti) / sum(ti)))
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0] and counts_ok
          and all(np.isfinite(b["losses"]).all() for b in blocks))
    print("phase6 train " + json.dumps(dict(
        route="b", batch=8, size=512, dtype="float32", losses=losses,
        launches_per_step=model.kernel_launches_per_train_step(), counts_ok=counts_ok,
        step_seconds=times, train_images_per_sec=rate, max_memory_allocated_bytes=peak,
        route_blocks_after=blocks, card=smi(), ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase6 FAILED: dkDualNet training path")
    if profile:
        for route, impl in (("b", "pallas"), ("a", None)):
            model.scan_impl = impl
            profile_step(f"dkdualnet train (route {route})",
                         lambda: train_step(state, x, y, loss_fn))
    return {"serve": serve, "train": train_counts}


# kernel-name fragments -> the layer that launched the kernel
_KERNEL_GROUPS = (
    ("mamba_fused_scan", ("mamba_chunk_kernel", "mamba_combine_kernel")),
    ("mamba_fused_scan_bwd pass C", ("mamba_bwd_chunk",)),
    ("mamba_fused_scan_bwd passes A, B, D", ("mamba_bwd_",)),
    ("tap_conv", ("tap_conv_kernel",)),
    ("tap_conv_bwd", ("tap_dfeat_kernel", "tap_dkernel_kernel")),
    ("selective_scan", ("scan_fwd_kernel", "scan_combine_kernel")),
    ("selective_scan_bwd", ("scan_bwd_",)),
    ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "winograd", "dgrad", "fprop")),
    ("matmul / einsum", ("gemm", "cutlass", "cublas", "sm90_", "sm80_")),
    ("norm", ("norm",)),
    ("interpolate / pool", ("upsample", "pool")),
    ("copy / cat / permute", ("copy", "cat", "transpose")),
    ("elementwise / reduce", ("elementwise", "reduce", "vectorized")),
)


def profile_step(path: str, step) -> None:
    """One profiled call of `step` (already warm): device time by layer and
    the top kernels, and the share of the wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    groups: dict[str, float] = {}
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, frags in _KERNEL_GROUPS if any(f in name for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    print(f"profile {path} " + json.dumps(dict(
        wall_ms=wall_ms, device_ms=total_ms, busy_share=total_ms / wall_ms,
        launches=sum(e.count for e in kernels),
        by_layer_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(name=e.key[:90], ms=e.self_device_time_total / 1e3, calls=e.count)
                     for e in top],
        card=smi())), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one bf16 sliding-window pass and one train step of "
                         "MM_Net and one route-b train step of dkDualNet (device time by layer)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs the GPU")
    from mm_unet_tpu_torch import _build

    print(smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN", flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator().manual_seed(args.seed)
    t_all = time.perf_counter()
    k = phase1_kernels(gen)
    k.update(phase1_backward(gen))
    k.update(phase1_scan(gen))
    print(f"phase1 done at {time.perf_counter() - t_all:.1f} s", flush=True)
    phase2_model(args.seed)
    phase2_gradients(args.seed)
    serve = phase3_serving(args.seed, args.profile)
    train, shapes = phase4_training(args.seed, args.profile)
    print(f"phases 2-4 done at {time.perf_counter() - t_all:.1f} s", flush=True)
    steps = phase1_step_shapes(shapes, args.seed)
    print(f"phase1 step shapes done at {time.perf_counter() - t_all:.1f} s", flush=True)
    phase5_dkdualnet(args.seed)
    dk = phase6_dkdualnet_path(args.seed, args.profile)
    print(f"phases 5-6 done at {time.perf_counter() - t_all:.1f} s", flush=True)
    if any(m.split(".")[0] in ("jax", "flax", "mm_unet_tpu") for m in sys.modules):
        raise SystemExit("chip_smoke: JAX or the JAX package was imported")
    unlaunched = [name for name, n in train.items() if n == 0]
    unlaunched += [f"{name} (dkDualNet {path})" for path, name in (
        ("serve", "selective_scan"), ("train", "selective_scan"), ("train", "selective_scan_bwd"))
        if dk[path][name] == 0]
    if unlaunched:
        raise SystemExit(f"chip_smoke: the main paths launched no {unlaunched}")

    def summary(name, source, replaces, paths, **extra):
        # times and bounds summed over the phase-1 bf16 shapes
        bf = [r for r in k[name] if r["dtype"] == "bfloat16"]
        top = max(bf, key=lambda r: r["bound_ms"])
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, **extra,
                "launches": paths["train"][name],
                "launches_by_path": {"serve": paths["serve"].get(name, 0),
                                     "train": paths["train"][name]},
                "max_abs_err": max(r["max_abs_err"] for r in k[name]),
                "ms": sum(r["ms"] for r in bf), "plain_ms": sum(r["plain_ms"] for r in bf),
                "bound_ms": sum(r["bound_ms"] for r in bf), "bound_by": top["bound_by"],
                "library_ms": None,  # no single PyTorch call computes this function
                "timed": "sum over the phase-1 bf16 shapes"}

    mm = {"serve": serve, "train": train}
    print(smi(), flush=True)
    print(json.dumps({"kernels": [
        summary("mamba_fused_scan", "mm_unet_tpu_torch/csrc/mamba_fused_fwd.cu",
                "mm_unet_tpu/ops/mamba_fused.py:240", mm),
        summary("mamba_fused_scan_bwd", "mm_unet_tpu_torch/csrc/mamba_fused_bwd.cu",
                "mm_unet_tpu/ops/mamba_fused.py:288", mm,
                **{f"step_{k}": sum(r[k] * r["launches_per_step"] for r in steps)
                   for k in ("ms", "kernel_ms", "bound_ms")},
                step_shapes=[{k: r[k] for k in ("D", "L", "reverse", "ms", "kernel_ms", "bound_ms",
                                                "launches_per_step")} for r in steps]),
        summary("tap_conv", "mm_unet_tpu_torch/csrc/tap_conv_fwd.cu",
                "mm_unet_tpu/ops/tap_conv.py:110", mm),
        summary("tap_conv_bwd", "mm_unet_tpu_torch/csrc/tap_conv_bwd.cu",
                "mm_unet_tpu/ops/tap_conv.py:133", mm),
        summary("selective_scan", "mm_unet_tpu_torch/csrc/selective_scan_fwd.cu",
                "mm_unet_tpu/ops/pallas_scan.py:242", dk,
                also_replaces="mm_unet_tpu/ops/pallas_scan.py:128"),
        summary("selective_scan_bwd", "mm_unet_tpu_torch/csrc/selective_scan_bwd.cu",
                "mm_unet_tpu/ops/pallas_scan.py:278", dk,
                also_replaces="mm_unet_tpu/ops/pallas_scan.py:169"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
