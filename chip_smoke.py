"""Smoke run of the PyTorch port on one NVIDIA GPU (the H100 it targets).

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from `mm_unet_tpu_torch/csrc/` (one nvcc
per source, in parallel) and runs, in order (every phase prints its lines;
any failure ends the run non-zero):

1. each forward kernel against its plain PyTorch version on the card, at
   the shapes MM_Net's 512² batch-8 path gives it, in f32 and bf16, forward
   and reverse, with the tolerance stated on the line and both times; then
   each backward kernel against autograd of the plain version at the same
   shapes, every input's gradient compared;
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
   and reads the peak device memory.

The last lines are the card's name and power limit, one JSON line of kernel
numbers, and `{"ok": true, "device": {...}}`. Without a CUDA device it exits
non-zero before printing any result. It imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

# tolerance on max |kernel - plain| relative to (1 + max |plain|): f32 differs
# only by summation order; bf16 by at most a couple of output ulps (2^-8
# relative) where an f32 sum lands on the other side of a rounding boundary
TOL = {torch.float32: 2e-4, torch.bfloat16: 1.6e-2}
# whole model, kernels on the card vs plain on the CPU, f32: conv libraries
# and sums in other orders through ~100 layers
MODEL_TOL = 2e-3
# backward kernels vs autograd of the plain versions, per input gradient:
# f32 sums over chunks, blocks and atomics in other orders; bf16 rounds the
# gradients at other points than the plain version's casts (a few bf16 ulps,
# added up over long sums)
BWD_TOL = {torch.float32: 5e-4, torch.bfloat16: 3e-2}
# every parameter gradient of the depth-1 MM_Net in train mode, card vs CPU,
# f32: the forward's differences carried back through ~40 layers and batch
# statistics over few values per channel at the deepest stage
GRAD_TOL = 1e-2
TRAIN_STEPS = 6


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


def compare(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    scale = 1.0 + want.float().abs().max().item()
    ok = err <= TOL[dtype] * scale
    return err, scale, ok


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
        xz = torch.cat([rn(B, 1, D, L, scale=0.5), rn(B, 1, D, L)], dim=2)
        w = (rn(1, D, W, scale=0.4), rn(1, D, scale=0.1), rn(1, R + 2 * N, D, scale=D ** -0.5),
             rn(1, D, R, scale=R ** -0.5), rn(1, D, scale=0.1) - 4.0,
             -torch.exp(torch.log(torch.arange(1, N + 1.0, device=dev)).repeat(1, D, 1)),
             torch.ones(1, D, device=dev))
        for dtype in (torch.float32, torch.bfloat16):
            x = xz.to(dtype)
            for rev in (False, True):
                got = mamba_fused_scan(x, *w, reverse=rev)
                torch.cuda.synchronize()
                want = mamba_fused_scan_ref(x, *w, reverse=rev)
                torch.cuda.synchronize()
                err, scale, ok = compare(got, want, dtype)
                ms = cuda_ms(lambda: mamba_fused_scan(x, *w, reverse=rev), reps=20)
                plain_ms = cuda_ms(lambda: mamba_fused_scan_ref(x, *w, reverse=rev), reps=1)
                rec = dict(D=D, L=L, B=B, dtype=str(dtype)[6:], reverse=rev, max_abs_err=err,
                           tol=TOL[dtype] * scale, ms=ms, plain_ms=plain_ms, ok=ok)
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
            err, scale, ok = compare(got, want, dtype)
            ms = cuda_ms(lambda: tap_conv(f, y, ker, bias, shifts), reps=20)
            plain_ms = cuda_ms(lambda: tap_conv_ref(f, y, ker, bias, shifts), reps=5)
            rec = dict(HW=hw, C=C, F=F, K=K, B=B, dtype=str(dtype)[6:], max_abs_err=err,
                       tol=TOL[dtype] * scale, ms=ms, plain_ms=plain_ms, ok=ok)
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


def compare_grads(got, want, names, dtype):
    errs = {}
    ok = True
    for name, g, w in zip(names, got, want):
        err = (g.float() - w.float()).abs().max().item()
        tol = BWD_TOL[dtype] * (1.0 + w.float().abs().max().item())
        errs[name] = [err, tol]
        ok = ok and err <= tol
    return errs, ok


def phase1_backward(gen) -> dict:
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan, mamba_fused_scan_ref
    from mm_unet_tpu_torch.ops.tap_conv import tap_conv, tap_conv_ref

    dev = torch.device("cuda")

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

    results = {"mamba_fused_scan_bwd": [], "tap_conv_bwd": []}
    failed = []

    def run(kind, shape, fn, ref, inputs, dout, names, dtype, plain_reps):
        out, live, got = grads_of(fn, inputs, dout)
        torch.cuda.synchronize()
        outp, livep, want = grads_of(ref, inputs, dout)
        torch.cuda.synchronize()
        errs, ok = compare_grads(got, want, names, dtype)
        ms = cuda_ms(lambda: torch.autograd.grad(out, live, dout, retain_graph=True), reps=10)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(outp, livep, dout, retain_graph=True),
                           reps=plain_reps, warmup=0)
        rec = dict(shape, dtype=str(dtype)[6:], max_abs_err=max(e for e, _ in errs.values()),
                   errs=errs, ms=ms, plain_ms=plain_ms, ok=ok)
        print(f"phase1 {kind} {json.dumps(rec)}", flush=True)
        results[kind].append(rec)
        failed.extend([] if ok else [rec])

    # the same shapes as the forward comparison
    for D, R, L in ((128, 4, 16384), (6, 1, 65536)):
        N, W, B = 16, 4, 2
        xz = torch.cat([rn(B, 1, D, L, scale=0.5), rn(B, 1, D, L)], dim=2)
        w = [rn(1, D, W, scale=0.4), rn(1, D, scale=0.1), rn(1, R + 2 * N, D, scale=D ** -0.5),
             rn(1, D, R, scale=R ** -0.5), rn(1, D, scale=0.1) - 4.0,
             -torch.exp(torch.log(torch.arange(1, N + 1.0, device=dev)).repeat(1, D, 1)),
             torch.ones(1, D, device=dev)]
        dout = rn(B, 1, D, L)
        names = ["xz", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b", "A", "D"]
        for dtype in (torch.float32, torch.bfloat16):
            for rev in (False, True):
                run("mamba_fused_scan_bwd", dict(D=D, L=L, B=B, reverse=rev),
                    lambda *a, r=rev: mamba_fused_scan(*a, reverse=r),
                    lambda *a, r=rev: mamba_fused_scan_ref(*a, reverse=r),
                    [xz.to(dtype), *w], dout.to(dtype), names, dtype, plain_reps=1)
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
                ["feat", "y", "kernel", "bias"], dtype, plain_reps=3)
    if failed:
        raise SystemExit(f"phase1 FAILED: {len(failed)} backward comparisons out of tolerance")
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
    worst, bad = [], 0
    for (name, pc), pg in zip(cpu_model.named_parameters(), gpu_model.parameters()):
        err = (pg.grad.cpu() - pc.grad).abs().max().item()
        rel = err / (1.0 + pc.grad.abs().max().item())
        worst.append((rel, name, err))
        bad += rel > GRAD_TOL
    worst.sort(reverse=True)
    ok = bad == 0 and all(bool(torch.isfinite(p.grad).all()) for p in gpu_model.parameters())
    print("phase2 gradients " + json.dumps(dict(
        params=len(worst), out_of_tol=bad, tol_relative=GRAD_TOL,
        worst=[dict(name=n, max_abs_err=e, relative=r) for r, n, e in worst[:4]],
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
    rates = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        predictor = make_predictor(model, dtype)
        inferer(x, predictor)  # warm-up
        torch.cuda.synchronize()
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            out = inferer(x, predictor)
        torch.cuda.synchronize()
        rates[name] = x.shape[0] * reps / (time.perf_counter() - t0)
        if not bool(torch.isfinite(out).all()):
            raise SystemExit(f"phase3 FAILED: non-finite {name} logits")
    print("phase3 throughput " + json.dumps(dict(
        roi=512, batch=8, overlap=0.5, images_per_sec_f32_predictor=rates["f32"],
        images_per_sec_bf16_predictor=rates["bf16"], card=smi())), flush=True)
    if profile:
        profile_step("serve", lambda: inferer(x, predictor))
    return launches


def phase4_training(seed: int, profile: bool = False) -> dict:
    """Train steps of the full-width bf16 MM_Net at 512² batch 8. Returns
    each kernel's launches over the run (forward and backward)."""
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
    for _ in range(TRAIN_STEPS):
        loss, dt, got = step()
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
    ok = (all(np.isfinite(losses)) and np.isfinite(loss_r) and losses[-1] < losses[0]
          and counts_ok and got_r == expect_r and state.step == TRAIN_STEPS + 1)
    print("phase4 train " + json.dumps(dict(
        batch=8, size=512, dtype="bfloat16", losses=losses, launches_per_step=expect,
        counts_ok=counts_ok, remat_step=dict(loss=loss_r, seconds=dt_r, launches=got_r,
                                             expected=expect_r),
        step_seconds=times, train_images_per_sec=rate, max_memory_allocated_bytes=peak,
        card=smi(), ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase4 FAILED: training path")
    if profile:
        model.remat = False
        profile_step("train", lambda: train_step(state, x, y, loss_fn))
    return totals


# kernel-name fragments -> the layer that launched the kernel
_KERNEL_GROUPS = (
    ("mamba_fused_scan", ("mamba_chunk_kernel", "mamba_combine_kernel")),
    ("mamba_fused_scan_bwd", ("mamba_bwd_",)),
    ("tap_conv", ("tap_conv_kernel",)),
    ("tap_conv_bwd", ("tap_dfeat_kernel", "tap_dkernel_kernel")),
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
                    help="also profile one bf16 sliding-window pass and one train step "
                         "(device time by layer)")
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
    k = phase1_kernels(gen)
    k.update(phase1_backward(gen))
    phase2_model(args.seed)
    phase2_gradients(args.seed)
    serve = phase3_serving(args.seed, args.profile)
    train = phase4_training(args.seed, args.profile)
    if any(m.split(".")[0] in ("jax", "flax", "mm_unet_tpu") for m in sys.modules):
        raise SystemExit("chip_smoke: JAX or the JAX package was imported")
    unlaunched = [name for name, n in train.items() if n == 0]
    if unlaunched:
        raise SystemExit(f"chip_smoke: the training path launched no {unlaunched}")

    def summary(name, source, replaces):
        bf = [r for r in k[name] if r["dtype"] == "bfloat16"]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": train[name],
                "launches_by_path": {"serve": serve.get(name, 0), "train": train[name]},
                "max_abs_err": max(r["max_abs_err"] for r in k[name]),
                "ms": sum(r["ms"] for r in bf), "plain_ms": sum(r["plain_ms"] for r in bf),
                "timed": "sum over the phase-1 bf16 shapes"}

    print(smi(), flush=True)
    print(json.dumps({"kernels": [
        summary("mamba_fused_scan", "mm_unet_tpu_torch/csrc/mamba_fused_fwd.cu",
                "mm_unet_tpu/ops/mamba_fused.py:240"),
        summary("mamba_fused_scan_bwd", "mm_unet_tpu_torch/csrc/mamba_fused_bwd.cu",
                "mm_unet_tpu/ops/mamba_fused.py:288"),
        summary("tap_conv", "mm_unet_tpu_torch/csrc/tap_conv_fwd.cu",
                "mm_unet_tpu/ops/tap_conv.py:110"),
        summary("tap_conv_bwd", "mm_unet_tpu_torch/csrc/tap_conv_bwd.cu",
                "mm_unet_tpu/ops/tap_conv.py:133"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
