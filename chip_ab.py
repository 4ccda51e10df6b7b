"""Runs parts of `chip_smoke.py` from checkouts of this repository on one
NVIDIA GPU, one subprocess a checkout: to compare a change with its parent
on the same card, in turns, or to show which phases a deliberately broken
copy of the kernels fails.

    python3 chip_ab.py steps TREE [TREE ...]   # e.g. build/parent . . build/parent
    python3 chip_ab.py phases TREE

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

phases: phase 1's backward comparisons, phase 2 and phase 7 of that tree,
each phase's failure caught; prints one `phases` JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys

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
                     ("phase7", lambda: cs.phase7_mm_routes(0))):
        try:
            fn()
            results[name] = "passed"
        except SystemExit as e:
            results[name] = f"failed: {e}"
    return results


def run(mode: str, tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA device; this run needs the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi(), flush=True)
    out = steps(cs) if mode == "steps" else phases(cs)
    print(f"{mode} " + json.dumps(dict(tree=tree, **out)), flush=True)


def main() -> None:
    if len(sys.argv) < 3 or sys.argv[1] not in ("steps", "phases"):
        raise SystemExit(__doc__)
    mode, trees = sys.argv[1], sys.argv[2:]
    if len(trees) == 1:
        run(mode, trees[0])
        return
    for tree in trees:  # one process a tree: each imports its own package
        rc = subprocess.call([sys.executable, __file__, mode, tree])
        if rc:
            raise SystemExit(f"chip_ab: {tree} exited {rc}")


if __name__ == "__main__":
    main()
