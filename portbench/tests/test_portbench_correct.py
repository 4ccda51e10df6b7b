"""What decides `correct`, at a size the CPU holds: the frozen references
against the port's plain CPU path, the configurations' kernel shapes
against the port's calls, a sound run of each cell's entry coming out
correct, the lower-precision control coming out far from the reference,
and the run's check coming out not correct with the timed path broken
underneath: a step that leaves the state unchanged, half of each batch left
out, an answer altered where it is produced."""

from __future__ import annotations

import json
import time

import pytest
import torch

from tiny import CELLS, tiny_cell
from harness import compare
from harness.refrun import reference_eval, reference_train

SEED = 2**31 + 17


def execute(cell) -> dict:
    """A run of `cell` on the CPU, its window long enough for the serving
    cell's sampled calls (one visit of each pool batch)."""
    import run

    seconds = 8.0 if cell.traffic["entry"] == "eval_loop" else 1.0
    return run.execute(cell, SEED, seconds, 0, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = execute(tiny_cell(name))
    assert result["correct"], result["compared"]
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared" and line["failed"] == 0 and line["attempted"] > 0
    assert {m for m in line["metrics"]} >= {"setup_s", "peak_mem_gib"}


@pytest.mark.parametrize("name", CELLS)
def test_reference_fits_the_port(name):
    """One state dict fits both, and in eval mode the frozen reference
    computes the port's plain CPU path's logits."""
    from mm_unet_tpu_torch.models import give_model

    cell = tiny_cell(name)
    port = give_model(cell.config["model"], device="cpu", **cell.config["model_kwargs"])
    ref = cell.reference().build(cell.config)
    assert set(port.state_dict()) == set(ref.state_dict())
    ref.load_state_dict(port.state_dict())
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = port.eval()(x), ref.eval()(x)
    assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def _record_calls(monkeypatch) -> dict:
    """{family: {shape: calls}} of the fused scans and tap-convs the port's
    model makes from here on, recorded at its call sites."""
    import mm_unet_tpu_torch.models.layers as layers
    import mm_unet_tpu_torch.models.mamba as mamba

    calls = {"mamba_fused": {}, "tap_conv": {}}

    def count(fam, key):
        calls[fam][key] = calls[fam].get(key, 0) + 1

    real_scan, real_tap = mamba.mamba_fused_scan, layers.tap_conv

    def scan(xz, conv_w, conv_b, x_proj, dt_w, *a, **k):
        b, _, d2, length = xz.shape
        count("mamba_fused", (b, d2 // 2, length, a[1].shape[2], dt_w.shape[2], conv_w.shape[2]))
        return real_scan(xz, conv_w, conv_b, x_proj, dt_w, *a, **k)

    def tap(feat, y, kernel, bias, shifts):
        b, h, w, c = feat.shape
        count("tap_conv", (b, h, w, c, kernel.shape[-1], y.shape[-1]))
        return real_tap(feat, y, kernel, bias, shifts)

    monkeypatch.setattr(mamba, "mamba_fused_scan", scan)
    monkeypatch.setattr(layers, "tap_conv", tap)
    return calls


@pytest.mark.parametrize("name", CELLS[:2])
def test_kernel_shapes_are_the_ports_calls(name, monkeypatch):
    """configs/<config>.py's shapes of one forward are the fused scans and
    tap-convs the port's model calls (recorded at its call sites)."""
    from mm_unet_tpu_torch.models import give_model

    cell = tiny_cell(name)
    calls = _record_calls(monkeypatch)
    model = give_model(cell.config["model"], device="cpu", **cell.config["model_kwargs"]).eval()
    with torch.no_grad():
        model(torch.randn(2, 3, 64, 64))
    want = cell.kernel_shapes()
    assert sorted(calls["mamba_fused"].items()) == want["mamba_fused"]
    assert sorted(calls["tap_conv"].items()) == want["tap_conv"]


@pytest.mark.parametrize("name", ["mm_net_f32_stare.train.b4", "mm_net_f32.train.b32"])
def test_recomputed_shapes_are_the_ports_calls(name, monkeypatch):
    """One training step (forward in training mode, backward) calls each
    launch of `kernel_shapes` once and each of `recomputed_shapes` once
    more: with remat on every tap-conv twice, with it off once; the scans
    once."""
    from mm_unet_tpu_torch.models import give_model

    cell = tiny_cell(name)
    calls = _record_calls(monkeypatch)
    model = give_model(cell.config["model"], device="cpu", **cell.config["model_kwargs"]).train()
    assert model.remat == cell.config["model_kwargs"]["remat"]
    model(torch.randn(2, 3, 64, 64)).float().square().mean().backward()
    want = {fam: dict(v) for fam, v in cell.kernel_shapes().items()}
    for fam, v in cell.recomputed_shapes().items():
        for shape, n in v:
            want[fam][shape] += n
    assert calls == want
    assert bool(cell.recomputed_shapes()) == cell.config["model_kwargs"]["remat"]


def _numbers(cell, quant):
    """(the program's numbers, the control's) for a cell: the port's first
    steps or calls against the reference, and the reference computed with
    `quant` (the CPU's stand-in for the card's TF32) against it."""
    import run

    entry = run.entry_for(cell, SEED, "cpu")
    entry.setup()
    if entry.kind == "serve":
        entry.run(count=2 * len(entry.pool), record=True)
        prog = {"losses": entry.window_losses, "logits": entry.kept}
        batches = dict(enumerate(entry.pool))
        ref = reference_eval(cell, entry.state0, batches, entry.device, 2)
        ctl = reference_eval(cell, entry.state0, batches, entry.device, 2, quant=quant)
        ctl = {"losses": list(ctl["losses"].items()), "logits": ctl["logits"]}
        return compare.serve_numbers(prog, ref), compare.serve_numbers(ctl, ref)
    steps = int(cell.traffic["ref_steps"])
    ref = reference_train(cell, entry.state0, entry.pool[:steps], entry.dropout_seed,
                          entry.device)
    ctl = reference_train(cell, entry.state0, entry.pool[:steps], entry.dropout_seed,
                          entry.device, quant=quant)
    return compare.train_numbers(entry.prog, ref), compare.train_numbers(ctl, ref)


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_far_from_the_reference(name):
    """The control (products rounded to TF32) reads at least ten times the
    sound program's gap on one of the cell's compared numbers."""
    from reference.plain import tf32_round

    cell = tiny_cell(name)
    prog, ctl = _numbers(cell, tf32_round)
    ratios = {k: ctl[k] / max(prog[k], 1e-12) for k in cell.limits}
    assert max(ratios.values()) >= 10, (prog, ctl)


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


def _half_batch(monkeypatch):
    """The loss over half of each batch, the forward over all of it, so
    that the logits keep their shape (`calibrate.half_batch_step`)."""
    import mm_unet_tpu_torch.train.loop as loop
    from calibrate import half_batch_step

    monkeypatch.setattr(loop, "train_step", half_batch_step(loop.train_step))


def _altered_answer(monkeypatch):
    from mm_unet_tpu_torch.train.inferers import SlidingWindowInferer

    real = SlidingWindowInferer.__call__

    def faulty(self, images, predictor):
        out = real(self, images, predictor)
        out[0] = -out[0]  # the first image's answer, altered where it is produced
        return out

    monkeypatch.setattr(SlidingWindowInferer, "__call__", faulty)


FAULTS = [("mm_net_f32.train.b32", _unchanged_state), ("um_net.train.b8", _unchanged_state),
          ("mm_net_f32.train.b32", _half_batch), ("um_net.train.b8", _half_batch),
          ("mm_net_f32.serve.b32", _altered_answer),
          ("mm_net_f32_stare.train.b4", _unchanged_state),
          ("mm_net_f32_stare.train.b4", _half_batch)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=lambda v: getattr(v, "__name__", v))
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result = execute(tiny_cell(name))
    assert not result["correct"], result["compared"]
