"""Where the benchmark's data lives, found by name: `BENCHMARK.json` at the
root of the checkout, a configuration's file (`configs/<config>.json`; the
module its `module` key names holds the kernel-shape function,
`configs/<module>.py`, and the plain reference, `reference/<module>.py`),
a traffic mix (`traffic/<traffic>.json`; the entry its `entry` key names,
`entries/<entry>.py`), a cell's limits (`workloads/<cell>.json`) and a
per-layer metric's reader (`metrics/<metric>.py`)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import zlib
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
# the end-to-end rate of each kind of entry (`Entry.kind`) in a cell made
# from data given here (`Cell.of`)
RATES = {"train": "train_images_per_s", "serve": "serve_images_per_s"}


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic and
    limits loaded."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench if bench is not None else benchmark()
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise KeyError(f"workload {name!r} is not in BENCHMARK.json ({sorted(work)})")
        self.name, self.entry = name, work[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config_name = conf["name"]
        self.config = read_json(ROOT / conf["file"])
        self.traffic = read_json(BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = read_json(BENCH_DIR / "workloads" / f"{name}.json")["limits"]
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if "workloads" not in m or name in m["workloads"]]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    @classmethod
    def of(cls, name: str, config_name: str, config: dict, traffic: dict, limits: dict,
           bench: dict | None = None) -> "Cell":
        """A cell from data given here, not from BENCHMARK.json's files (the
        tests' small cells); its metrics are those BENCHMARK.json gives a
        cell of the same kind."""
        cell = cls.__new__(cls)
        cell.name, cell.entry, cell.config_name = name, {"chips": 1}, config_name
        cell.config, cell.traffic, cell.limits, cell.chips = config, traffic, limits, 1
        bench = bench if bench is not None else benchmark()
        rate = RATES[entry_class(traffic["entry"]).kind]
        cell.end_to_end = [m for m in bench["end_to_end"]
                           if m["name"] in (rate, "peak_mem_gib", "setup_s")]
        cell.per_layer = [m for m in bench["per_layer"] if m["moves"] == rate]
        return cell

    def kernel_shapes(self) -> dict:
        """The configuration's kernel shapes of one forward at this cell's
        batch and size (`configs/<module>.py::kernel_shapes`): {family:
        [(shape, launches)]}."""
        return self._shapes(self._config_module().kernel_shapes)

    def recomputed_shapes(self) -> dict:
        """The forward launches a training step runs again in its backward
        (remat), as `kernel_shapes` gives them
        (`configs/<module>.py::recomputed_shapes`); none where the module
        has no such function."""
        fn = getattr(self._config_module(), "recomputed_shapes", None)
        return self._shapes(fn) if fn else {}

    def _config_module(self):
        return importlib.import_module(f"configs.{self.config['module']}")

    def _shapes(self, fn) -> dict:
        return fn(self.config, int(self.traffic["batch"]), int(self.traffic["size"]))

    def reference(self):
        return importlib.import_module(f"reference.{self.config['module']}")


def entry_class(name: str):
    """`Entry` of `entries/<name>.py`."""
    return importlib.import_module(f"entries.{name}").Entry


def metric_reader(name: str):
    """`read(ctx)` of `metrics/<name>.py`."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (`tag`) of the run's --seed."""
    return (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(tag.encode())) % (1 << 63)
