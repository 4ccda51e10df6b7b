"""The readings a cell's limits are set from, on the card at the cell's own
sizes (never part of a benchmark run):

    python portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--half-batch] [--leaves] [--bf16] [--own-init]

For each seed: the program's readings through the cell's own entry (its
first steps, or a short stretch of evaluation calls), the plain reference,
and the lower-precision control, the reference computed one precision
below the configuration's (`control` in its file: TF32 for f32, fp8 for a
bf16 feature path), with whether the cell's limits pass each. With
--half-batch (training cells) also the program with its loss taken over
half of each batch, the forward still over all of it. With --leaves
(training cells) the look leaf by leaf at the leaves whose gradient or
change reads widest: the program's gaps beside those of the reference
started from weights nudged by one unit in the last place, which no fault
moves, and the share of elements whose change has the other sign. --bf16
runs an MM_Net cell on the bf16 feature path (control fp8), --own-init
from the model's own initialisation drawn from the seed instead of the
benchmark's weights. Each line printed is one seed's numbers against the
reference."""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from harness import compare, device  # noqa: E402
from harness.refrun import reference_eval, reference_train  # noqa: E402
from harness.spec import Cell, benchmark, sub_seed  # noqa: E402


def control_kwargs(cell: Cell) -> dict:
    """The reference one precision below the configuration's: TF32
    products for an f32 configuration, fp8 products for a bf16 one."""
    if cell.config["control"] == "tf32":
        return {"tf32": True}
    if cell.config["control"] == "fp8":
        from reference.plain import fp8_round

        return {"quant": fp8_round}
    raise ValueError(f"no control for {cell.config['control']!r}")


def half_batch_step(step):
    """`step` (the loop's `train_step`) with its loss taken over the first
    half of the batch: the forward still runs over all of it, so the
    logits keep their shape, and the loss's mean runs over the rest."""

    def faulty(state, images, labels, loss_fn, sample_weight=None):
        def half(logits, target, weight=None):
            n = logits.shape[0] // 2
            return loss_fn(logits[:n], target[:n], weight=None if weight is None else weight[:n])

        return step(state, images, labels, half, sample_weight)

    return faulty


def half_batch():
    """Patch the loop's train step with `half_batch_step`; returns the undo."""
    import mm_unet_tpu_torch.train.loop as loop

    step = loop.train_step
    loop.train_step = half_batch_step(step)
    return lambda: setattr(loop, "train_step", step)


def nudged(state: dict, seed: int) -> dict:
    """`state` with every float element moved one unit in the last place,
    up or down as drawn from the seed."""
    out = {}
    for i, (n, v) in enumerate(sorted(state.items())):
        if not v.is_floating_point():
            out[n] = v
            continue
        g = torch.Generator(device=v.device).manual_seed(sub_seed(seed, f"nudge{i}"))
        up = torch.rand(v.shape, generator=g, device=v.device) < 0.5
        inf = torch.full_like(v, float("inf"))
        out[n] = torch.nextafter(v, torch.where(up, inf, -inf))
    return out


def leaf_look(prog: dict, ref: dict, other: dict, k: int = 4) -> list:
    """For the k leaves of widest change gap and the k of widest gradient
    gap, on the program's side and on `other`'s (the nudged reference):
    each side's gaps of the first gradient's norm, of the change's norm
    after the first step and after the last (`compare.train_gaps`'
    measure), the first gradient's relative gap as a vector, and the share
    of elements whose change has the other sign than the reference's, with
    those elements' median |gradient| over the leaf's rms gradient."""
    g_med = statistics.median(ref["grad"].values())
    moving = [n for n, g in ref["grad"].items() if g >= compare.STILL_LEAF * g_med]
    c_med = statistics.median(ref["change"][n] for n in moving)
    c1_med = statistics.median(ref["change1"][n] for n in moving)

    def gap(side, key, n, floor):
        return abs(side[key][n] - ref[key][n]) / max(ref[key][n], floor)

    pick = []
    for side in (prog, other):
        for key, floor in (("change", c_med), ("grad", g_med)):
            pick += sorted(moving, key=lambda n: -gap(side, key, n, floor))[:k]
    rows = []
    for n in dict.fromkeys(pick):
        g = ref["grad_t"][n]
        rms = float(g.square().mean().sqrt())
        row = {"leaf": n, "numel": g.numel(), "grad_over_median": ref["grad"][n] / g_med}
        for name, side in (("program", prog), ("nudged", other)):
            flip = torch.sign(side["change_t"][n]) != torch.sign(ref["change_t"][n])
            row[name] = {
                "grad_gap": gap(side, "grad", n, g_med),
                "grad_vector_gap": float((side["grad_t"][n] - g).norm()) / max(float(g.norm()),
                                                                             1e-30),
                "change1_gap": gap(side, "change1", n, c1_med),
                "change_gap": gap(side, "change", n, c_med),
                "flip_share": float(flip.float().mean()),
                "flipped_grad_over_rms": (float(g.abs()[flip].median()) / max(rms, 1e-30)
                                          if flip.any() else None),
            }
        rows.append(row)
    return rows


def program(cell: Cell, seed: int, calls: int, own_init: bool = False, keep: bool = False):
    from run import entry_for

    entry = entry_for(cell, seed, "cuda")
    entry.own_init, entry.keep_tensors = own_init, keep
    entry.setup()
    if entry.kind == "serve":
        entry.run(count=calls, record=True)
        prog = {"losses": entry.window_losses, "logits": entry.kept}
    else:
        prog = entry.prog
    entry.free()
    return entry, prog


def numbers(kind: str, got: dict, ref: dict) -> dict:
    return (compare.train_numbers if kind == "train" else compare.serve_numbers)(got, ref)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--half-batch", action="store_true")
    ap.add_argument("--leaves", action="store_true")
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--own-init", action="store_true")
    args = ap.parse_args()
    device.fix_caches()
    cell = Cell(args.workload, benchmark())
    if args.bf16:
        if cell.config["model"] != "MM_Net":
            raise SystemExit("--bf16: only MM_Net has a bf16 feature path")
        cell.config = copy.deepcopy(cell.config)
        cell.config["model_kwargs"]["mamba_dtype"] = "bfloat16"
        cell.config.update(product_dtype="bfloat16", control="fp8")
    device.require_cards(1)
    t = cell.traffic
    calls = 2 * int(t["pool"]) if t["entry"] == "eval_loop" else 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        entry, prog = program(cell, seed, calls, args.own_init, args.leaves)
        row = {"seed": seed}
        kind = entry.kind
        if kind == "serve":
            batches = dict(enumerate(entry.pool))
            ref = reference_eval(cell, entry.state0, batches, entry.device, int(t["ref_rows"]))
            if not args.no_control:
                ctl = reference_eval(cell, entry.state0, batches, entry.device,
                                     int(t["ref_rows"]), **control_kwargs(cell))
                ctl = {"losses": list(ctl["losses"].items()), "logits": ctl["logits"]}
        else:
            batches = entry.pool[:int(t["ref_steps"])]
            ref = reference_train(cell, entry.state0, batches, entry.dropout_seed, entry.device,
                                  keep=args.leaves)
            row["program_losses"], row["reference_losses"] = prog["losses"], ref["losses"]
            if not args.no_control:
                ctl = reference_train(cell, entry.state0, batches, entry.dropout_seed,
                                      entry.device, **control_kwargs(cell))
            if args.leaves:
                other = reference_train(cell, nudged(entry.state0, seed), batches,
                                        entry.dropout_seed, entry.device, keep=True)
                row["nudged"] = numbers(kind, other, ref)
                row["nudged_widest"] = {k: w for k, (_, w) in
                                        compare.train_gaps(other, ref).items()}
                row["program_widest"] = {k: w for k, (_, w) in
                                         compare.train_gaps(prog, ref).items()}
                row["leaves"] = leaf_look(prog, ref, other)
            if args.half_batch:
                undo = half_batch()
                try:
                    _, faulty = program(cell, seed, calls, args.own_init)
                finally:
                    undo()
                row["half_batch"] = numbers(kind, faulty, ref)
        row["program"] = numbers(kind, prog, ref)
        if not args.no_control:
            row["control"] = numbers(kind, ctl, ref)
        for side in ("program", "control", "half_batch"):
            if side in row:
                row[side + "_correct"] = compare.judge(row[side], cell.limits)
        row["seconds"] = time.perf_counter() - t0
        print("calibrate " + json.dumps(row), flush=True)
    found = device.forbidden_modules()
    if found:
        print(f"portbench: modules of the JAX package loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
