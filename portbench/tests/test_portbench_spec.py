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
import torch

from tiny import full_cell  # (also puts the benchmark on sys.path)
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


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("es", [2, 4])
def test_scan_work_equals_chip_smoke(es, backward):
    import chip_smoke

    for B, Dm, L, N, G, bes, streams, const in ((8, 384, 4096, 16, 1, 4, 3, False),
                                                (4, 1536, 2048, 16, 4, 2, 2, False),
                                                (2, 96, 1024, 16, 1, 4, 2, True)):
        args = (B, Dm, L, N, G, es, bes, streams, backward, const)
        assert work.scan_work(*args) == chip_smoke.scan_work(*args)
        got = work.least_ms({"selective_scan": [((B, Dm, L, N, G, bes, streams, const), 3)]},
                            es, backward)
        assert got["selective_scan"] == pytest.approx(
            3 * chip_smoke.bound(*chip_smoke.scan_work(*args))[0], rel=1e-12)


# the parent harness's products and least kernel ms of a step at each cell's
# full size, which the harness's generalisation keeps exactly
PARENT = {
    "mm_net_f32.train.b32": (5183951142912.0, {"mamba_fused": 16.59056160143284,
                                               "tap_conv": 20.7238465719403}),
    "um_net.train.b8": (2164849901568.0, {"mamba_fused": 1.1963445492537312,
                                          "tap_conv": 2.705360926567164}),
    "mm_net_f32.serve.b32": (1380936253440.0, {"mamba_fused": 4.391601549850746,
                                               "tap_conv": 6.883535444059701}),
}


@pytest.mark.parametrize("name", sorted(PARENT))
def test_existing_cells_read_as_at_the_parent(name):
    cell = Cell(name, benchmark())
    train = cell.traffic["entry"] == "train_loop"
    shapes, again = cell.kernel_shapes(), cell.recomputed_shapes()
    assert again == {}
    flops, least = PARENT[name]
    assert work.least_ms_per_step(shapes, again, 4, train) == least
    assert work.model_flops(cell.reference(), cell.config, int(cell.traffic["batch"]),
                            int(cell.traffic["size"]), train) == flops


def test_remat_cell_counts_its_recompute():
    """The 704 remat cell's step: every tap-conv once more in the backward,
    its forward work added to the least time; the scans once. It reads as
    a training cell: the training rate and its ten per-layer metrics."""
    cell = full_cell("mm_net_f32_stare.train.b4")
    assert {m["name"] for m in cell.end_to_end} == {"train_images_per_s", "peak_mem_gib",
                                                   "setup_s"}
    assert sorted(m["name"] for m in cell.per_layer) == sorted(
        m["name"] for m in benchmark()["per_layer"] if m["name"].endswith(".train"))
    shapes, again = cell.kernel_shapes(), cell.recomputed_shapes()
    assert again == {"tap_conv": shapes["tap_conv"]}
    assert work.launches_per_step(shapes, again, True) == {"mamba_fused": (150, 150),
                                                           "tap_conv": (94, 47)}
    fwd, bwd = work.least_ms(shapes, 4, False), work.least_ms(shapes, 4, True)
    least = work.least_ms_per_step(shapes, again, 4, True)
    assert least == {"mamba_fused": fwd["mamba_fused"] + bwd["mamba_fused"],
                     "tap_conv": fwd["tap_conv"] + bwd["tap_conv"] + fwd["tap_conv"]}


def test_reference_scan_in_ragged_blocks(monkeypatch):
    """The reference's block-wise scan over a length that is no multiple of
    its block, nor of its chunk, equals the scan by doubling."""
    from reference import plain

    g = torch.Generator().manual_seed(3)
    b, d, n, length = 2, 3, 4, 75
    u, dt = torch.randn(b, d, length, generator=g), torch.rand(b, d, length, generator=g)
    A = -torch.rand(d, n, generator=g) - 0.5
    Bm, Cm = torch.randn(b, n, length, generator=g), torch.randn(b, n, length, generator=g)
    want = plain._doubling(u, dt, A, Bm, Cm)
    monkeypatch.setattr(plain, "SMALL_SCAN_BYTES", 0)
    monkeypatch.setattr(plain, "SCAN_BLOCK_BYTES", 32 * b * d * n * 4)  # blocks of 32 tokens
    got = plain.selective_scan(u, dt, A, Bm, Cm)
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


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


def test_trace_groups_of_the_cells_kernels():
    """Every kernel name of the cells' traces keeps the group it had before
    the attention group came in (tests/kernel_names.json)."""
    names = json.loads((BENCH_DIR / "tests" / "kernel_names.json").read_text())["groups"]
    assert len(names) > 100
    assert {n: trace.group_of(n) for n in names} == names


@pytest.mark.parametrize("name", [
    "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<128, 64, 64, 4, false, false, "
    "cutlass::bfloat16_t, Flash_kernel_traits<128, 64, 64, 4, cutlass::bfloat16_t> >, false, "
    "true, false, false, true, true, false, false>(pytorch_flash::Flash_fwd_params)",
    "void pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel<Flash_bwd_kernel_traits<128,"
    " 64, 128, 8, 2, 4, 2, false, false, cutlass::bfloat16_t>, true, false, false, false, false, "
    "true, false, false>(pytorch_flash::Flash_bwd_params)",
    "void pytorch_flash::flash_bwd_convert_dq_kernel<Flash_bwd_kernel_traits<128, 64, 128, 8, 2, "
    "4, 2, false, false, cutlass::bfloat16_t>, true, false>(pytorch_flash::Flash_bwd_params, int)",
    "fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel<float, "
    "cutlass::arch::Sm80, true, 64, 64, 64, true, true>::Params)",
    "fmha_cutlassB_f32_aligned_64x64_k64_sm80(PyTorchMemEffAttention::AttentionBackwardKernel<"
    "cutlass::arch::Sm80, float, true, false, true, 64, 64, 64, false>::Params)",
    "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_3_64x64x128_4x1x1_kernel0_0",
    "cudnn_generated_fort_native_sdpa_sm90_flash_bprop_wgmma_f16_knob_7_64x128x128_4x1x1"
    "_kernel0_0",
])
def test_trace_groups_attention(name):
    assert trace.group_of(name) == "attention"


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
