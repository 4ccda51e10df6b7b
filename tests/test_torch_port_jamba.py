"""Jamba (`models/jamba.py`) against the benchmark's plain reference
(`portbench/reference/jamba.py`, loaded by path) on the CPU, at a small
width on seeded random weights: logits, the next-token loss, every
gradient, one AdamW step through `train_one_epoch` on int64 token batches;
planted faults fail the same comparison; at the published widths (on the
meta device) the layer pattern and the parameter counts; the Mamba mixer's
route with and without Jamba's norms; `stage` keeping token ids. The card
test holds the model on kernels 5-6 and a fused attention kernel to its
CPU path. This file imports no JAX: on the card, run it with
`python3 -m pytest --noconftest -q tests/test_torch_port_jamba.py`."""

from __future__ import annotations

import importlib
import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mm_unet_tpu_torch.models.jamba as jamba
import mm_unet_tpu_torch.models.mamba as mamba_mod
from mm_unet_tpu_torch.models import give_model
from mm_unet_tpu_torch.models.jamba import JambaAttention, JambaForCausalLM
from mm_unet_tpu_torch.models.mamba import Mamba
from mm_unet_tpu_torch.train.loop import stage, train_one_epoch
from mm_unet_tpu_torch.train.losses import next_token_loss
from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn

BENCH = Path(__file__).resolve().parent.parent / "portbench"
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=1, attn_layer_period=4,
             attn_layer_offset=2, mamba_d_state=16, mamba_dt_rank=4)
BATCH, LENGTH = 2, 64
# f32 on both sides, summed in other orders (the scan token by token against
# the reference's chunks and doubling, SDPA against written-out softmax):
# each number reads ~1e-6 of its size here (logits 7e-7, the widest
# gradient 2e-6 of its leaf's norm); 1e-4 leaves rounding 50x room, and a
# planted fault reads 6e-2 or more
TOL = 1e-4
LR = 1e-3


def reference():
    """portbench/reference/jamba.py with the benchmark on sys.path."""
    for p in (str(BENCH), str(BENCH.parent)):
        if p not in sys.path:
            sys.path.insert(0, p)
    return importlib.import_module("reference.jamba")


def config(**over) -> dict:
    """SMALL as a configuration's `model_kwargs`: every key of the model."""
    sig = inspect.signature(JambaForCausalLM).parameters
    return {"model_kwargs": {**{k: p.default for k, p in sig.items() if k != "generator"},
                             **SMALL, **over}}


def state(seed: int) -> dict:
    """Random weights for SMALL: the port's draws, with the norms' weights
    moved off 1 so that a dropped norm shows."""
    g = torch.Generator().manual_seed(seed)
    model = give_model("Jamba", device="cpu", generator=g, **SMALL)
    return {k: v + 0.2 * torch.randn(v.shape, generator=g) if "layernorm" in k else v
            for k, v in model.state_dict().items()}


def tokens(seed: int, n: int = 1) -> list[torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, SMALL["vocab_size"], (BATCH, LENGTH), generator=g)
            for _ in range(n)]


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def port_and_reference(seed: int):
    sd = state(seed)
    port = give_model("Jamba", device="cpu", **SMALL)
    ref = reference().build(config())
    port.load_state_dict(sd)
    ref.load_state_dict(sd)
    return port, ref


def forward_backward(model, ids, loss):
    for p in model.parameters():
        p.grad = None
    out = model(ids)
    val = loss(out)
    val.backward()
    return out.detach(), val.detach(), {n: torch.zeros_like(p) if p.grad is None else p.grad
                                         for n, p in model.named_parameters()}


def gaps(seed: int = 1) -> dict:
    """The port's logits, loss and widest gradient against the reference's."""
    port, ref = port_and_reference(seed)
    (ids,) = tokens(seed + 100)
    a = forward_backward(port.train(), ids, lambda out: next_token_loss(out, ids))
    b = forward_backward(ref.train(), ids, lambda out: reference().loss(out, {"tokens": ids}))
    return {"logits": rel(a[0], b[0]), "loss": abs(float(a[1] - b[1])) / float(b[1]),
            "grad": max(rel(a[2][n], b[2][n]) for n in b[2])}


def test_logits_loss_and_gradients_match_the_reference():
    got = gaps()
    assert max(got.values()) <= TOL, got


def _drop_dt_norm(monkeypatch):
    real = mamba_mod._rms_rows
    monkeypatch.setattr(mamba_mod, "_rms_rows", lambda x, norm: (
        x if norm.weight.shape[0] == SMALL["mamba_dt_rank"] else real(x, norm)))


def _not_causal(monkeypatch):
    real = F.scaled_dot_product_attention
    monkeypatch.setattr(F, "scaled_dot_product_attention",
                        lambda q, k, v, is_causal, scale: real(q, k, v, is_causal=False,
                                                               scale=scale))


@pytest.mark.parametrize("fault", [_drop_dt_norm, _not_causal], ids=lambda f: f.__name__)
def test_planted_faults_fail(fault, monkeypatch):
    fault(monkeypatch)
    got = gaps()
    assert max(got.values()) > 100 * TOL, got


def test_one_adamw_step_through_the_loop_matches_the_reference():
    """One `train_step` of the loop on an int64 token batch: its loss, the
    first gradient as AdamW holds it (exp_avg / (1 - beta1)) and each
    leaf's change against the reference's step with its own AdamW (lr and
    weight decay as given, betas (0.9, 0.95)). A first AdamW step moves an
    element by lr * g / (|g| + eps): the change's norm is rounding-proof
    except where |g| is near eps, so it is held as tightly as the
    gradient."""
    port, ref = port_and_reference(3)
    AdamW = importlib.import_module("reference.train").AdamW
    start = {n: p.detach().clone() for n, p in port.named_parameters()}
    (ids,) = tokens(7)
    trainer = {"lr": LR, "warmup": 1, "num_epochs": 2, "weight_decay": 0.1}
    st = create_train_state(port, {"trainer": trainer})
    losses = []

    class Tracker:
        def log(self, scalars, step):
            if "Train/total_loss" in scalars:
                losses.append(scalars["Train/total_loss"])

    metric = train_one_epoch(st, make_loss_fn({"next_token_loss": {}}, {"next_token_loss": 1.0}),
                             [{"tokens": ids.numpy()}], {}, tracker=Tracker())
    assert set(metric) == {"Train/images_per_sec"} and st.step == 1

    opt = AdamW(ref.named_parameters(), lr=LR, weight_decay=0.1, betas=(0.9, 0.95), eps=1e-8,
                no_decay=["A_log", "D"])
    out = ref(ids)
    loss = reference().loss(out, {"tokens": ids})
    loss.backward()
    opt.step()
    loss = loss.detach()
    assert abs(losses[0] - float(loss)) <= TOL * float(loss)
    named = dict(port.named_parameters())
    for n, p in ref.named_parameters():
        g = st.optimizer.state[named[n]]["exp_avg"] / (1 - 0.9)
        assert rel(g, p.grad) <= TOL, n
        changed = named[n].detach() - start[n]
        assert abs(float(changed.norm()) - float((p.detach() - start[n]).norm())) <= (
            TOL * float((p.detach() - start[n]).norm())), n


def test_published_widths_on_the_meta_device():
    """AI21-Jamba2-3B's defaults: attention at layers 7 and 21 of 28, and
    the parameters of each part."""
    with torch.device("meta"):
        model = JambaForCausalLM()
    attn = [i for i, layer in enumerate(model.layers) if layer.mixer_name == "self_attn"]
    assert attn == [7, 21] and len(model.layers) == 28

    def count(m):
        return sum(p.numel() for p in m.parameters())

    assert count(model.layers[0].mamba) == 41_241_792
    assert count(model.layers[7].self_attn) == 13_762_560
    assert {count(layer.feed_forward) for layer in model.layers} == {62_914_560}
    assert count(model.embed_tokens) == 167_772_160
    assert model.kernel_launches_per_forward() == {"selective_scan": 26, "attention": 2}
    with torch.device("meta"):
        period = JambaForCausalLM(num_hidden_layers=14)
    assert count(period) == 1_598_556_096  # one period, the benchmark's cell


def test_mamba_routes_with_and_without_the_norms(monkeypatch):
    """Jamba's norms send the mixer to the grouped scan (one selective_scan
    call, kernels 5-6 on the card) under their own names; without them the
    mixer keeps the megakernel route at d_state 16 and its parameters."""
    calls = []
    real = mamba_mod.selective_scan
    monkeypatch.setattr(mamba_mod, "selective_scan",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    names = {"in_proj.weight", "conv1d.weight", "conv1d.bias", "x_proj.weight",
             "dt_proj.weight", "dt_proj.bias", "A_log", "D", "out_proj.weight"}
    normed = Mamba(32, dt_rank=4, bimamba_type="none", ssm_norm_eps=1e-6)
    assert not normed.use_mega and normed.kernel_launches_per_forward() == {"selective_scan": 1}
    assert set(dict(normed.named_parameters())) == names | {
        "dt_layernorm.weight", "b_layernorm.weight", "c_layernorm.weight"}
    normed(torch.randn(2, 8, 32))
    assert calls == [1]
    plain = Mamba(32, dt_rank=4, bimamba_type="none")
    assert plain.use_mega and plain.kernel_launches_per_forward() == {"mamba_fused_scan": 1}
    assert set(dict(plain.named_parameters())) == names
    with pytest.raises(ValueError, match="one direction"):
        Mamba(32, bimamba_type="v3", ssm_norm_eps=1e-6)


def test_kernel_launches_are_the_calls():
    """kernel_launches_per_forward: one scan a Mamba layer, one
    `causal_attention` an attention layer, as a forward makes them."""
    model = give_model("Jamba", device="cpu", **SMALL)
    before = jamba.causal_attention.launches
    with torch.no_grad():
        model(tokens(1)[0])
    assert jamba.causal_attention.launches - before == 1
    assert model.kernel_launches_per_forward() == {"selective_scan": 3, "attention": 1}
    assert sum(isinstance(m, JambaAttention) for m in model.modules()) == 1


def test_stage_keeps_token_ids():
    ids = np.array([[0, 2**40 + 1, 65535]], dtype=np.int64)
    got = stage(ids, torch.device("cpu"))
    assert got.dtype == torch.int64 and got.tolist() == ids.tolist()
    assert stage(ids.astype(np.int32), torch.device("cpu")).dtype == torch.int64
    assert stage(np.ones((1, 2), np.float64), torch.device("cpu")).dtype == torch.float32
    assert stage(np.ones((1, 2), bool), torch.device("cpu")).dtype == torch.float32


def test_next_token_loss_weights_whole_sequences():
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(3, 5, 7, generator=g)
    ids = torch.randint(0, 7, (3, 5), generator=g)
    want = F.cross_entropy(logits[:, :-1].reshape(-1, 7), ids[:, 1:].reshape(-1))
    assert torch.allclose(next_token_loss(logits, ids), want)
    assert torch.allclose(next_token_loss(logits, ids, torch.ones(3)), want)
    first = next_token_loss(logits[:1], ids[:1])
    assert torch.allclose(next_token_loss(logits, ids, torch.tensor([1.0, 0.0, 0.0])), first)


@pytest.mark.cuda
def test_card_matches_the_cpu_path():
    """The small model on the card (kernels 5-6, SDPA's fused kernel) against
    its CPU path: logits and every gradient; 3 + 3 scan launches and one
    attention call a step; and no tensor of every head's (L, L) scores is
    made, forward or backward (the math path would make one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels 5-6 have no CPU mode)")
    from torch.utils._python_dispatch import TorchDispatchMode

    from mm_unet_tpu_torch.ops.chunked_scan import selective_scan_chunked

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = state(5)
    cpu = give_model("Jamba", device="cpu", **SMALL)
    card = give_model("Jamba", device="cuda", **SMALL)
    cpu.load_state_dict(sd)
    card.load_state_dict(sd)
    (ids,) = tokens(9)
    heads = SMALL["num_attention_heads"]
    scores = (BATCH, heads, LENGTH, LENGTH)

    class Shapes(TorchDispatchMode):
        seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    self.seen.add(tuple(t.shape))
            return out

    f0, b0 = selective_scan_chunked.launches, selective_scan_chunked.bwd_launches
    a0 = jamba.causal_attention.launches
    with Shapes() as mode:
        got = forward_backward(card.train(), ids.cuda(),
                               lambda out: next_token_loss(out, ids.cuda()))
    assert scores not in mode.seen
    scans = selective_scan_chunked.launches - f0, selective_scan_chunked.bwd_launches - b0
    assert scans == (3, 3)
    assert jamba.causal_attention.launches - a0 == 1
    want = forward_backward(cpu.train(), ids, lambda out: next_token_loss(out, ids))
    assert rel(got[0].cpu(), want[0]) <= TOL
    assert abs(float(got[1]) - float(want[1])) <= TOL * float(want[1])
    for n, g in want[2].items():
        assert rel(got[2][n].cpu(), g) <= TOL, n
