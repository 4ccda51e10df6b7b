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

from harness.spec import Cell, benchmark  # noqa: E402

CELLS = ("mm_net_f32.train.b32", "um_net.train.b8", "mm_net_f32.serve.b32")


def tiny_cell(name: str) -> Cell:
    """`name`'s cell at batch 2, 64 x 64, MM_Net one block a stage (four
    slices each), with the cell's own limits; a serving cell compares the
    first call of each pool batch, so that a slow CPU's short window holds
    them."""
    full = Cell(name, benchmark())
    cfg = copy.deepcopy(full.config)
    if cfg["model"] == "MM_Net":
        cfg["model_kwargs"].update(depths=[1, 1, 1, 1], num_slices_list=[4, 4, 4, 4])
    traffic = dict(full.traffic, batch=2, size=64, ref_rows=2)
    if "sample_visits" in traffic:  # the first visit of each pool batch is compared
        traffic["sample_visits"] = 1
    return Cell.of(name, full.config_name, cfg, traffic, full.limits)
