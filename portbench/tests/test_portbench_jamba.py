"""The Jamba2-3B cell (`jamba2_3b.train.s8192`) at a size the CPU holds, made
with `Cell.of` from its own files at a small width: the configuration
against the port's published widths, its products against a count by hand,
the scan family's least time from `configs/jamba.py`, those shapes against
the port's calls, the reference reading `tokens` and taking the next-token
loss, a sound run coming out correct and broken timed paths not."""

from __future__ import annotations

import copy
import inspect
import subprocess
import sys
import time

import pytest
import torch
import torch.nn.functional as F

import tiny  # noqa: F401  (puts the benchmark on sys.path)
from harness import work
from harness.refrun import reference_eval, reference_train
from harness.spec import BENCH_DIR, ROOT, Cell, benchmark

NAME = "jamba2_3b.train.s8192"
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=1, attn_layer_period=4,
             attn_layer_offset=2, mamba_dt_rank=4)
BATCH, LENGTH = 2, 64
SEED = 2**31 + 23


def small_cell() -> Cell:
    """The cell at SMALL's widths, batch 2 and 64 tokens, with its own
    limits and metrics."""
    full = Cell(NAME, benchmark())
    cfg = copy.deepcopy(full.config)
    cfg["model_kwargs"].update(SMALL)
    return Cell.of(NAME, full.config_name, cfg, dict(full.traffic, batch=BATCH, size=LENGTH),
                   full.limits)


def test_configuration_is_the_published_one_cut_to_one_period():
    """The file's top-level keys are the model's keyword arguments, which
    are AI21-Jamba2-3B's published values but for the one cut it lists."""
    from mm_unet_tpu_torch.models.jamba import JambaForCausalLM

    cell = Cell(NAME, benchmark())
    kw = cell.config["model_kwargs"]
    assert {k: cell.config[k] for k in kw} == kw
    published = {k: p.default for k, p in inspect.signature(JambaForCausalLM).parameters.items()
                 if k != "generator"}
    assert set(kw) == set(published)
    assert {k for k in kw if kw[k] != published[k]} == set(cell.config["reduced"]) == {
        "num_hidden_layers"}
    assert kw["num_hidden_layers"] * 2 == published["num_hidden_layers"]
    assert kw["num_hidden_layers"] == kw["attn_layer_period"]  # one whole period
    assert [m["name"] for m in cell.end_to_end] == ["train_images_per_s", "peak_mem_gib",
                                                    "setup_s"]


@pytest.mark.parametrize("train", [False, True])
def test_products_match_a_count_by_hand(train):
    """Per token: each Mamba layer's in_proj, x_proj, dt_proj and out_proj
    (its depthwise conv is elementwise work in the reference), the
    attention layer's four projections and its scores and weighted values
    (each query against the keys up to its block's last), every layer's
    three MLP products and the tied head; a training step adds two products
    in the backward for each."""
    cell = small_cell()
    m = cell.config["model_kwargs"]
    dm, di, v = m["hidden_size"], m["intermediate_size"], m["vocab_size"]
    d, r, n = 2 * dm, m["mamba_dt_rank"], m["mamba_d_state"]
    tokens = BATCH * LENGTH
    mamba = 2 * tokens * (dm * 2 * d + d * (r + 2 * n) + r * d + d * dm)
    attn = 2 * tokens * (dm * dm + 2 * dm * (dm // 4) + dm * dm)
    # one block of queries (64 <= QUERY_BLOCK) against all 64 keys: q k^T and p v
    attn += 2 * 2 * BATCH * LENGTH * LENGTH * dm
    mlp = 2 * tokens * 3 * dm * di
    forward = 3 * mamba + attn + 4 * mlp + 2 * tokens * dm * v
    got = work.model_flops(cell.reference(), cell.config, BATCH, LENGTH, train)
    assert got == (3 if train else 1) * forward


def test_least_ms_of_the_scan_family():
    """configs/jamba.py gives the cell 13 scans of 5,120 channels over 8,192
    tokens a forward; their least time is chip_smoke.py's, forward and
    backward, and no other family has a launch."""
    import chip_smoke

    cell = Cell(NAME, benchmark())
    shape = (1, 5120, 8192, 16, 1, 4, 3, False)
    shapes, again = cell.kernel_shapes(), cell.recomputed_shapes()
    assert shapes == {"selective_scan": [(shape, 13)]} and again == {}
    assert work.launches_per_step(shapes, again, True) == {"selective_scan": (13, 13)}
    each = [chip_smoke.bound(*chip_smoke.scan_work(*shape[:5], 4, *shape[5:7], bw, shape[7]))[0]
            for bw in (False, True)]
    got = work.least_ms_per_step(shapes, again, 4, True)
    assert got == {"selective_scan": pytest.approx(13 * (each[0] + each[1]), rel=1e-12)}


def test_kernel_shapes_are_the_ports_calls(monkeypatch):
    """The small cell's shapes of one forward are the selective scans the
    port's model calls (recorded at its call site): (B, Dm, L, N, groups,
    B/C element size, streams, constant B/C)."""
    import mm_unet_tpu_torch.models.mamba as mamba
    from mm_unet_tpu_torch.models import give_model

    cell = small_cell()
    calls: dict = {}
    real = mamba.selective_scan

    def scan(u, delta, A, B, C, D=None, z=None, **kw):
        key = (u.shape[0], u.shape[1], u.shape[2], A.shape[1], 1 if B.ndim < 4 else B.shape[1],
               B.element_size(), 2 + (z is not None), B.ndim == 2)
        calls[key] = calls.get(key, 0) + 1
        return real(u, delta, A, B, C, D=D, z=z, **kw)

    monkeypatch.setattr(mamba, "selective_scan", scan)
    model = give_model("Jamba", device="cpu", **cell.config["model_kwargs"])
    with torch.no_grad():
        model(torch.zeros(BATCH, LENGTH, dtype=torch.long))
    assert sorted(calls.items()) == cell.kernel_shapes()["selective_scan"]


def _state_and_batches(cell):
    from mm_unet_tpu_torch.models import give_model

    g = torch.Generator().manual_seed(5)
    model = give_model("Jamba", device="cpu", generator=g, **cell.config["model_kwargs"])
    batches = [{"tokens": torch.randint(0, SMALL["vocab_size"], (BATCH, LENGTH), generator=g)}
               for _ in range(2)]
    return model.state_dict(), batches


def test_reference_reads_tokens_and_takes_the_next_token_loss():
    """The reference's steps and evaluation read `tokens` and take the
    next-token loss: the first step's loss and the evaluation's losses are
    the cross-entropy of the model at the start state."""
    cell = small_cell()
    state, batches = _state_and_batches(cell)
    model = cell.reference().build(cell.config)
    model.load_state_dict(state)

    def ce(b):
        out = model(b["tokens"])
        return float(F.cross_entropy(out[:, :-1].flatten(0, 1), b["tokens"][:, 1:].flatten()))

    with torch.no_grad():
        want = [ce(b) for b in batches]
    res = reference_train(cell, state, batches, 0, "cpu")
    assert res["losses"][0] == pytest.approx(want[0], rel=1e-6)
    assert res["losses"][1] != pytest.approx(want[1], rel=1e-6)  # the first step moved it
    assert res["logits"].shape == (BATCH, LENGTH, SMALL["vocab_size"])
    ev = reference_eval(cell, state, dict(enumerate(batches)), "cpu", rows=1)
    assert [ev["losses"][k] for k in (0, 1)] == pytest.approx(want, rel=1e-5)


def test_reference_imports_neither_package():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import reference.jamba, configs.jamba\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'mm_unet_tpu', 'mm_unet_tpu_torch')))\n") % str(BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def execute(cell) -> dict:
    import run

    return run.execute(cell, SEED, 1.0, 0, "cpu", time.perf_counter())


def test_sound_run_is_correct():
    result = execute(small_cell())
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and set(result["metrics"]) == {
        "train_images_per_s", "peak_mem_gib", "setup_s"}


def _unchanged_state(monkeypatch):
    import mm_unet_tpu_torch.train.loop as loop

    step = loop.train_step

    def faulty(state, *a, **k):
        before = [p.detach().clone() for p in state.model.parameters()]
        out = step(state, *a, **k)
        with torch.no_grad():
            for p, q in zip(state.model.parameters(), before):
                p.copy_(q)
        return out

    monkeypatch.setattr(loop, "train_step", faulty)


def _dt_norm_dropped(monkeypatch):
    """dt's RMSNorm without its normalisation (its weight kept, so that it
    still takes a gradient)."""
    import mm_unet_tpu_torch.models.mamba as mamba

    real = mamba._rms_rows
    monkeypatch.setattr(mamba, "_rms_rows", lambda x, norm: (
        norm.weight[:, None] * x if norm.weight.shape[0] == SMALL["mamba_dt_rank"]
        else real(x, norm)))


def _not_causal(monkeypatch):
    real = F.scaled_dot_product_attention
    monkeypatch.setattr(F, "scaled_dot_product_attention",
                        lambda q, k, v, is_causal, scale: real(q, k, v, is_causal=False,
                                                               scale=scale))


@pytest.mark.parametrize("fault", [_unchanged_state, _dt_norm_dropped, _not_causal],
                         ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = execute(small_cell())
    assert not result["correct"], result["compared"]
