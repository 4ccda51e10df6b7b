"""The benchmark's definition and yardstick, without running a model:
BENCHMARK.json against the contract's form, the files it names, the work
functions against chip_smoke.py's, the argument parsing, the trace reading
and the import check."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

import tiny  # noqa: F401  (puts the benchmark on sys.path)
from harness import trace, work
from harness.spec import BENCH_DIR, ROOT, Cell, benchmark, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_benchmark_json_form():
    b = benchmark()
    assert set(b) == KEYS["top"]
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[section]]
        assert len(names) == len(set(names))
        for e in b[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        reporting = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reporting
    for w in b["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["config"]) and NAME.match(w["traffic"])
        cell = Cell(w["name"], b)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer


def test_named_files_exist():
    b = benchmark()
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        module = json.loads((ROOT / c["file"]).read_text())["module"]
        assert (BENCH_DIR / "configs" / f"{module}.py").is_file()
        assert (BENCH_DIR / "reference" / f"{module}.py").is_file()
    for w in b["workloads"]:
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((BENCH_DIR / "workloads" / f"{w['name']}.json").read_text())["limits"]
        assert limits and all(v > 0 for v in limits.values())
    for m in b["per_layer"]:
        assert callable(metric_reader(m["name"]))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("es", [2, 4])
def test_work_functions_equal_chip_smoke(es, backward):
    import chip_smoke

    for shape in ((8, 6, 16384, 16, 1, 4), (32, 128, 65536, 16, 4, 4)):
        assert work.mamba_work(*shape, es, backward) == chip_smoke.mamba_work(*shape, es,
                                                                               backward)
        assert work.bound(*work.mamba_work(*shape, es, backward)) == pytest.approx(
            chip_smoke.bound(*chip_smoke.mamba_work(*shape, es, backward))[0])
    for shape in ((8, 128, 128, 64, 64, 3), (8, 4, 4, 192, 12, 9)):
        assert work.tap_work(*shape, es, backward) == chip_smoke.tap_work(*shape, es, backward)
        assert work.bound(*work.tap_work(*shape, es, backward)) == pytest.approx(
            chip_smoke.bound(*chip_smoke.tap_work(*shape, es, backward))[0])


def test_arguments():
    import run

    a = run.parse(["--workload", "um_net.train.b8", "--seed", str(2**31 + 5), "--seconds", "40",
                   "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("um_net.train.b8", 2**31 + 5, 40.0, 1)
    with pytest.raises(SystemExit):
        run.parse(["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"])


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints nothing on stdout."""
    proc = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                           "um_net.train.b8", "--seed", "3", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_trace_union_and_gaps():
    busy = trace._merge([(0, 10), (5, 12), (20, 30), (29, 31)])
    assert busy == [[0, 12], [20, 31]]
    host = [(0, 40, "outer"), (13, 19, "inner"), (14, 15, "innermost")]
    gaps = trace.Trace._gaps(busy, host)
    assert gaps == {"inner": pytest.approx(8e-6)}  # mid 16: inside outer and inner only


def test_trace_groups_first_match():
    assert trace.group_of("void tap_conv_kernel<float>") == "tap_conv"
    assert trace.group_of("cudnn::conv2d_fprop") == "convolution (cuDNN)"
    assert trace.group_of("multi_tensor_apply_kernel<FusedAdamMathFunctor>") == "optimizer (AdamW)"


def test_imports_name_no_jax_package():
    """The run's own modules and the port it drives load nothing whose
    top-level name is jax, jaxlib, flax or mm_unet_tpu (compared whole)."""
    code = (
        "import sys, importlib; sys.path[:0] = [%r, %r]\n"
        "import run, calibrate\n"
        "from harness import device, spec\n"
        "for m in ('entries.train_loop', 'entries.eval_loop', 'reference.mm_net', "
        "'reference.um_net', 'reference.train', 'configs.mm_net', 'configs.um_net'):\n"
        "    importlib.import_module(m)\n"
        "import mm_unet_tpu_torch.models, mm_unet_tpu_torch.evaluate, "
        "mm_unet_tpu_torch.train.loop\n"
        "for m in spec.benchmark()['per_layer']: spec.metric_reader(m['name'])\n"
        "assert 'mm_unet_tpu_torch' in sys.modules\n"
        "print(device.forbidden_modules())\n") % (str(BENCH_DIR), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_compares_whole_names(monkeypatch):
    from harness import device

    monkeypatch.setitem(sys.modules, "mm_unet_tpu_torch_fake", object())
    assert "mm_unet_tpu_torch_fake" not in device.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mm_unet_tpu.fake", object())
    assert device.forbidden_modules() == ["mm_unet_tpu.fake"]
