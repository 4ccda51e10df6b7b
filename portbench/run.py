"""The benchmark of the PyTorch and CUDA port, `mm_unet_tpu_torch`.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run: build (or load) the port's kernels, make the weights and the
images from the seed on the card, warm the cell's shapes through its first
steps, measure for --seconds, check the program's output against the
plain reference, and print one JSON line last on standard output. See
portbench/README.md.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

from harness import compare, device  # noqa: E402
from harness.spec import RATES, Cell, benchmark, entry_class  # noqa: E402

GIB = float(1 << 30)


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def entry_for(cell: Cell, seed: int, dev):
    return entry_class(cell.traffic["entry"])(cell, seed, dev)


def measure(entry, seconds: float, sync) -> tuple[int, float]:
    """(items, seconds) of the timed window: items done over the whole
    time from the first issue to the last result."""
    t0 = time.perf_counter()
    kw = {"record": True} if entry.kind == "serve" else {}
    items = entry.run(deadline=t0 + seconds, **kw)
    sync()
    return items, time.perf_counter() - t0


def traced(entry, cell: Cell, n: int, items: int, elapsed: float) -> tuple[dict, dict, dict]:
    """Profile `n` steps (calls) after the window; returns (per-layer
    metrics, the device fields, the breakdown)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from harness.spec import metric_reader
    from harness.trace import Trace
    from harness.work import launches_per_step, least_ms_per_step, model_flops

    train = entry.kind == "train"
    shapes = cell.kernel_shapes()
    again = cell.recomputed_shapes() if train else {}
    per_step = launches_per_step(shapes, again, train)
    before = entry.counters()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        entry.run(count=n)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    after = entry.counters()
    for fam, (f0, b0) in before.items():
        f1, b1 = after[fam]
        want = tuple(k * n for k in per_step.get(fam, (0, 0)))
        if (f1 - f0, b1 - b0) != want:
            raise SystemExit(f"portbench: {fam} launched {(f1 - f0, b1 - b0)} (forward, backward) "
                             f"over {n} traced steps; the configuration's shapes give {want}")
    trace = Trace(prof, window_s)
    es = 2 if cell.config["product_dtype"] == "bfloat16" else 4
    batch = int(cell.traffic["batch"])
    ctx = {
        "kind": entry.kind, "steps": n, "trace": trace,
        "least_ms_per_step": least_ms_per_step(shapes, again, es, train),
        "flops_per_step": model_flops(cell.reference(), cell.config, batch,
                                      int(cell.traffic["size"]), train),
        "peak_flops": float(cell.config["product_peak_flops"]),
        "steps_per_s": items / batch / elapsed,
    }
    metrics = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics, {"busy_s": trace.busy_s, "window_s": trace.window_s}, trace.breakdown()


def execute(cell: Cell, seed: int, seconds: float, trace: int, dev, t_start: float) -> dict:
    """One run of `cell` on `dev`: set-up, the window, the traced stretch
    (trace 1), the check against the reference. Returns the result line's
    object, its `compared` entry last."""
    import torch

    entry = entry_for(cell, seed, dev)
    entry.setup()
    sync = torch.cuda.synchronize if entry.device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s")
    if entry.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    items, elapsed = measure(entry, seconds, sync)
    peak = torch.cuda.max_memory_allocated() if entry.device.type == "cuda" else 0
    log(f"window {elapsed:.3f} s, {items} images, peak {peak} B")
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
              "device": {**device.card(cell.chips), "memory_peak_bytes": peak}
              if entry.device.type == "cuda" else {"platform": "cpu", "count": 1,
                                                  "memory_peak_bytes": 0}}
    if trace:
        metrics, dev_fields, breakdown = traced(entry, cell, int(cell.traffic["traced_steps"]),
                                                items, elapsed)
        result["metrics"], result["breakdown"] = metrics, breakdown
        result["device"].update(dev_fields)
        log(f"traced stretch read at {time.perf_counter() - t_start:.2f} s")
    else:
        values = {RATES[entry.kind]: items / elapsed, "peak_mem_gib": peak / GIB,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["attempted"] = items // int(cell.traffic["batch"])
    entry.free()
    t_ref = time.perf_counter()
    prog, ref = entry.check()
    log(f"reference {time.perf_counter() - t_ref:.2f} s")
    if entry.kind == "train":
        gaps = compare.train_gaps(prog, ref)
        numbers = {k: v for k, (v, _) in gaps.items()}
        log("gaps " + ", ".join(f"{k} {v:.6g} ({w})" for k, (v, w) in gaps.items()))
        log(f"losses {prog['losses']} reference {ref['losses']}")
    else:
        numbers = compare.serve_numbers(prog, ref)
        log("gaps " + ", ".join(f"{k} {v:.6g}" for k, v in numbers.items()))
    result["correct"] = compare.judge(numbers, cell.limits)
    result["failed"] = 0 if result["correct"] else result["attempted"]
    result["compared"] = {k: {"value": numbers.get(k), "limit": lim}
                          for k, lim in cell.limits.items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    device.fix_caches()
    cell = Cell(args.workload, benchmark())
    import torch

    device.require_cards(cell.chips)
    torch.set_num_threads(4)
    result = execute(cell, args.seed, args.seconds, args.trace, "cuda", T_START)
    found = device.forbidden_modules()
    if found:
        print(f"portbench: modules of the JAX package loaded: {found}", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"{k} {v['value']:.6g} limit {v['limit']:.6g}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except device.NoCard as e:
        print(e, file=sys.stderr)
        sys.exit(2)
