"""Runs parts of `chip_smoke.py` from checkouts of this repository on one
NVIDIA GPU, one subprocess a checkout: to compare a change with its parent
on the same card, in turns, or to show which phases a deliberately broken
copy of the kernels fails.

    python3 chip_ab.py steps TREE [TREE ...]   # e.g. build/parent . . build/parent
    python3 chip_ab.py fwd TREE [TREE ...]
    python3 chip_ab.py sweep TREE
    python3 chip_ab.py lm TREE [TREE ...]
    python3 chip_ab.py phases TREE [TREE ...]

A TREE is a directory holding a checkout (`git archive` of a commit,
unpacked under `build/`, which `.gitignore` lists). Each builds its own
kernels into its own `build/kernels/`.

steps: the fused Mamba backward (kernel 2) alone at every shape of one
MM_Net bf16 train step (512², batch 8; read by phase 4's hooks, after phase
4's train steps and its profiled step, whose `profile train` line gives the
step's device ms), of one UM_Net f32 step and of one HWAUNETR f32 step
(512², batch 8: D 128 at L 4,096 to 65,536; D 96 to 768, three directions)
through `phase1_step_shapes`; prints a `steps` JSON line per tree with the
sums of device ms (`kernel_ms`) and bound times launches per step.

fwd: the fused Mamba forward and backward (kernels 1 and 2) alone at each
width the port ran before mamba-370m (`FWD_SHAPES`), f32 and bf16, forward
and reverse: a hash of kernel 1's output, chunk-entry states and sums of dt
and of kernel 2's eight gradients, and each kernel's device ms; with
several trees a `fwd summary` line says, shape by shape, whether every tree
gave the same bits, with each tree's device ms.

sweep: kernel 1 at the Mamba LMs' scoring shapes (B 4, L 2048; D 1536 and
2048) and at HWAUNETR's two widest stages (B 8; D 384, L 1024 and D 768, L
256), f32 (`SWEEP_SHAPES`), with each chunk's channels split into blocks of
each of `SWEEP_DC` channels below D and whole where that fits, device ms
in two turns and whether each split gives the whole launch's bits.

lm: mamba-130m (`give_lm()`, f32, weights from seed 0) at LM_SCORE: the
scoring forward and the route-a training pass of `chip_smoke.py`'s phase 10
(the backbone's output y, loss (y * w).sum(), backward): wall ms of each
call after a warm-up, tokens/s from their median, device ms of a call and
kernel 1's and kernel 2's share of it (torch.profiler), peak memory, and a
hash of the logits and of y with its in_proj gradients; with several
trees an `lm summary` line says whether every tree gave the same bits,
with each tree's tokens/s. Only the package's public entry points are
called, so a parent checkout runs it as it stands.

phases: phase 1's backward comparisons, phase 2 (its f32 and bf16 passes
with every tap-conv and fused-scan call held to its plain version), phase 7
and phase 10's kernels 1 and 2 at mamba-370m's width (D 2048, where kernel
1 splits each chunk's channels over blocks) of that tree, each phase's
failure caught; prints one `phases` JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys

# (B, D, R, L) of kernel 1 at the widths the port ran before mamba-370m:
# MM_Net's offset and RCG Mambas (phase 1's shapes), UM_Net's D 128 at its
# shortest, dkDualNet's three route-a stages, HWAUNETR's widest stage and
# mamba-130m's scoring shape
FWD_SHAPES = ((2, 2, 1, 65536), (2, 6, 1, 65536), (2, 128, 4, 16384), (8, 128, 4, 4096),
              (8, 96, 3, 16384), (8, 192, 6, 4096), (8, 384, 12, 1024), (8, 768, 24, 256),
              (4, 1536, 48, 2048))
SWEEP_DC = (128, 192, 256, 384, 512)
SWEEP_SHAPES = ((4, 1536, 48, 2048), (4, 2048, 64, 2048), (8, 384, 12, 1024), (8, 768, 24, 256))
LM_REPS = {"scoring": 10, "training": 5}
UM_NET = {(8, 128, 4, 16, 4, L, False, "float32"): 1 for L in (4096, 16384, 65536)}
HWAUNETR = {(8, D, D // 32, 16, 4, L, rev, "float32"): 1 if rev else 2
            for D, L in ((96, 16384), (192, 4096), (384, 1024), (768, 256))
            for rev in (False, True)}


def steps(cs) -> dict:
    _, shapes, _ = cs.phase4_training(0, profile=True)
    out = {}
    for tag, sh in (("mm_net", shapes), ("um_net", UM_NET), ("hwaunetr", HWAUNETR)):
        _, bwd = cs.phase1_step_shapes(sh, 0, f"steps_{tag}")
        out[tag] = dict(kernel_ms=sum(r["kernel_ms"] * r["launches_per_step"] for r in bwd),
                        bound_ms=sum(r["bound_ms"] * r["launches_per_step"] for r in bwd),
                        launches=sum(r["launches_per_step"] for r in bwd), shapes=len(bwd))
    return out


def phases(cs) -> dict:
    import torch

    gen = torch.Generator().manual_seed(0)
    results = {}
    for name, fn in (("phase1 backward", lambda: cs.phase1_backward(gen)),
                     ("phase2 model", lambda: cs.phase2_model(0)),
                     ("phase2 gradients", lambda: cs.phase2_gradients(0)),
                     ("phase2 bf16 gradients", lambda: cs.phase2_bf16_gradients(0)),
                     ("phase7", lambda: cs.phase7_mm_routes(0)),
                     ("phase10 370m kernels", lambda: cs.lm_kernels(40, 2048, 64, "phase10 370m"))):
        try:
            fn()
            results[name] = "passed"
        except SystemExit as e:
            results[name] = f"failed: {e}"
    return results


def fwd(cs) -> dict:
    import hashlib

    import torch

    from mm_unet_tpu_torch.ops.mamba_fused import (
        _kernel_operands, _launch_fwd, mamba_fused_scan)

    def digest(tensors):
        sha = hashlib.sha256()
        for t in tensors:
            sha.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
        return sha.hexdigest()[:16]

    dev, out = torch.device("cuda"), {}
    for B, D, R, L in FWD_SHAPES:
        gen = torch.Generator().manual_seed(D + L)
        rn = lambda *sh, scale=1.0: (torch.randn(*sh, generator=gen) * scale).to(dev)  # noqa: E731
        xz, w = cs.mamba_inputs(rn, dev, B, D, R, L)
        dout = rn(B, 1, D, L)
        for dtype in (torch.float32, torch.bfloat16):
            x, d = xz.to(dtype), dout.to(dtype)
            # the weights as `mamba_fused_scan` hands them to the kernel
            ops = _kernel_operands(x, *(t.to(dtype) if i in (0, 2, 3) else t
                                        for i, t in enumerate(w)))
            for rev in (False, True):
                call = lambda: _launch_fwd(x, ops, rev)  # noqa: E731
                rec = dict(sha=digest(call()), kernel_ms=cs.kernel_device_ms(call, cs.FWD_KERNELS))
                y, live, grads = cs.grads_of(lambda *a: mamba_fused_scan(*a, reverse=rev),
                                             [x, *w], d)
                call = lambda: torch.autograd.grad(y, live, d, retain_graph=True)  # noqa: E731
                rec.update(bwd_sha=digest(grads),
                           bwd_kernel_ms=cs.kernel_device_ms(call, cs.BWD_KERNELS))
                out[f"B {B} D {D} L {L} {str(dtype)[6:]} {'reverse' if rev else 'forward'}"] = rec
                del y, live, grads
        del xz, w, dout, x, d, ops
    return out


def sweep(cs) -> dict:
    import torch

    from mm_unet_tpu_torch.ops.mamba_fused import _fwd_plan, _kernel_operands, _launch_fwd

    dev, out = torch.device("cuda"), {}
    for B, D, R, L in SWEEP_SHAPES:
        gen = torch.Generator().manual_seed(D)
        rn = lambda *sh, scale=1.0: (torch.randn(*sh, generator=gen) * scale).to(dev)  # noqa: E731
        xz, w = cs.mamba_inputs(rn, dev, B, D, R, L)
        ops = _kernel_operands(xz, *w)
        sizes = [c for c in SWEEP_DC if c < D]
        try:
            _fwd_plan(D, R + 32, 16, D)
            sizes.append(D)
        except ValueError:  # the whole chunk does not fit a block
            pass
        with torch.no_grad():
            whole = _launch_fwd(xz, ops, False, D) if D in sizes else None
            for Dc in sizes:
                got = _launch_fwd(xz, ops, False, Dc)
                out[f"B {B} D {D} L {L} Dc {Dc}"] = dict(
                    nb=_fwd_plan(D, R + 32, 16, Dc)["nb"], kernel_ms=[],
                    same_bits=None if whole is None
                    else all(torch.equal(a, b) for a, b in zip(got, whole)))
                del got
            del whole
            for turn in range(2):
                for Dc in sizes:
                    out[f"B {B} D {D} L {L} Dc {Dc}"]["kernel_ms"].append(cs.kernel_device_ms(
                        lambda: _launch_fwd(xz, ops, False, Dc), cs.FWD_KERNELS))
        del xz, w, ops
    return out


def lm(cs) -> dict:
    import hashlib
    import time

    import numpy as np
    import torch

    from mm_unet_tpu_torch.models.lm import MAMBA_130M, give_lm

    (B, L), cfg = cs.LM_SCORE, MAMBA_130M
    model = give_lm(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg["vocab_size"], (B, L))).cuda()
    w = torch.from_numpy(rng.standard_normal((B, L, cfg["d_model"])).astype(np.float32)).cuda()
    bb, n_layer = model.backbone, cfg["n_layer"]

    def digest(tensors):
        sha = hashlib.sha256()
        for t in tensors:
            sha.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
        return sha.hexdigest()[:16]

    def scoring():
        with torch.inference_mode():
            return model(ids)

    def training():
        bb.zero_grad(set_to_none=True)
        y = bb(ids)
        (y * w).sum().backward()
        return y.detach()

    out = {}
    for name, fn in (("scoring", scoring), ("training", training)):
        fn()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        grads = ([] if name == "scoring"
                 else [layer.mixer.in_proj.weight.grad for layer in bb.layers])
        sha = digest([res, *grads])
        del res, grads
        walls = []
        for _ in range(LM_REPS[name]):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        med = sorted(walls)[len(walls) // 2]
        ops = cs.call_device_ops(fn, reps=2)
        out[name] = dict(
            sha=sha, wall_ms=walls, tokens_per_s=B * L / med * 1e3, device_ms=ops["device_ms"],
            kernel1_ms=cs.kernel_device_ms(fn, cs.FWD_KERNELS) * n_layer,
            kernel2_ms=(cs.kernel_device_ms(fn, cs.BWD_KERNELS) * n_layer
                        if name == "training" else None),
            max_memory_allocated_bytes=peak)
    return out


def run(mode: str, tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA device; this run needs the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi(), flush=True)
    out = {"steps": steps, "fwd": fwd, "sweep": sweep, "phases": phases, "lm": lm}[mode](cs)
    print(f"{mode} " + json.dumps(dict(tree=tree, **out)), flush=True)


def main() -> None:
    if len(sys.argv) < 3 or sys.argv[1] not in ("steps", "fwd", "sweep", "phases", "lm"):
        raise SystemExit(__doc__)
    mode, trees = sys.argv[1], sys.argv[2:]
    if len(trees) == 1:
        run(mode, trees[0])
        return
    lines = []
    for tree in trees:  # one process a tree: each imports its own package
        res = subprocess.run([sys.executable, __file__, mode, tree], stdout=subprocess.PIPE,
                             text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            raise SystemExit(f"chip_ab: {tree} exited {res.returncode}")
        lines += [json.loads(ln[len(mode) + 1:]) for ln in res.stdout.splitlines()
                  if ln.startswith(f"{mode} {{")]
    if mode == "fwd":
        print("fwd summary " + json.dumps({
            key: {f"{part}{k}": [ln[key][f"{part}kernel_ms"] for ln in lines] if k == "ms"
                  else len({ln[key][f"{part}sha"] for ln in lines}) == 1
                  for part in ("", "bwd_") for k in ("same_bits", "ms")}
            for key in lines[0] if key != "tree"}), flush=True)
    if mode == "lm":
        print("lm summary " + json.dumps({
            key: {"same_bits": len({ln[key]["sha"] for ln in lines}) == 1,
                  "tokens_per_s": [ln[key]["tokens_per_s"] for ln in lines],
                  "device_ms": [ln[key]["device_ms"] for ln in lines]}
            for key in ("scoring", "training")}), flush=True)


if __name__ == "__main__":
    main()
