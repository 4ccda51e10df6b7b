"""Small cells of the benchmark for the CPU tests: the configurations'
widths and the traffic's loops and limits, at a depth, batch and size the
CPU holds, with the port's plain CPU path as the program."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.spec import BENCH_DIR, Cell, benchmark, read_json  # noqa: E402

CELLS = ("mm_net_f32.train.b32", "um_net.train.b8", "mm_net_f32.serve.b32",
         "mm_net_f32_stare.train.b4")
# cells whose files the benchmark holds, calibrated, but which BENCHMARK.json
# does not list: {cell: (configuration, traffic)}
WAITING = {"mm_net_f32_stare.train.b4": ("mm_net_f32_stare", "train.704.b4")}


def full_cell(name: str) -> Cell:
    """`name`'s cell at its full size: from BENCHMARK.json, or for a cell of
    `WAITING` from its files, with the metrics of a cell of its kind."""
    if name not in WAITING:
        return Cell(name, benchmark())
    config, traffic = WAITING[name]
    return Cell.of(name, config, read_json(BENCH_DIR / "configs" / f"{config}.json"),
                   read_json(BENCH_DIR / "traffic" / f"{traffic}.json"),
                   read_json(BENCH_DIR / "workloads" / f"{name}.json")["limits"])


def tiny_cell(name: str) -> Cell:
    """`name`'s cell at batch 2, 64 x 64, MM_Net one block a stage (four
    slices each), with the cell's own limits; a serving cell compares the
    first call of each pool batch, so that a slow CPU's short window holds
    them."""
    full = full_cell(name)
    cfg = copy.deepcopy(full.config)
    if cfg["model"] == "MM_Net":
        cfg["model_kwargs"].update(depths=[1, 1, 1, 1], num_slices_list=[4, 4, 4, 4])
    traffic = dict(full.traffic, batch=2, size=64, ref_rows=2)
    if "sample_visits" in traffic:  # the first visit of each pool batch is compared
        traffic["sample_visits"] = 1
    return Cell.of(name, full.config_name, cfg, traffic, full.limits)
