"""A token model's configuration goes through the harness as new files would
bring it, with no file of the harness edited: its reference module gives
the input of the FLOP count (`example_input`: (batch, size) int64 ids),
the input its model reads from a batch (`model_input`) and its loss
(`loss`); its configuration module gives the shapes of a hand-written
family other than the image models' (`selective_scan`); its entry, under a
file name of its own, is a training entry. The modules are made here and
put where the harness looks them up by name."""

from __future__ import annotations

import sys
import types

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import tiny  # noqa: F401  (puts the benchmark on sys.path)
from harness import work
from harness.refrun import reference_eval, reference_train
from harness.spec import Cell

VOCAB, D_MODEL, D_INNER, N_STATE = 64, 16, 32, 4
BATCH, LENGTH = 2, 16
CFG = {"name": "tiny_lm", "model": "TinyLM", "module": "tiny_lm", "model_kwargs": {},
       "product_dtype": "float32",
       "optimizer": {"lr": 1e-3, "weight_decay": 0.05, "betas": [0.9, 0.95], "eps": 1e-8,
                     "no_decay": []}}
TRAFFIC = {"entry": "tiny_lm_steps", "batch": BATCH, "size": LENGTH, "pool": 2, "ref_steps": 2,
           "traced_steps": 2}
# one launch shape of the scan: (B, Dm, L, N, G, B/C element size, streams, constant B/C)
SCAN = (BATCH, D_INNER, LENGTH, N_STATE, 1, 4, 3, False)


class TinyLM(nn.Module):
    """Token embedding, one projection, and the head tied to the embedding."""

    def __init__(self):
        super().__init__()
        self.embed = nn.Embedding(VOCAB, D_MODEL)
        self.proj = nn.Linear(D_MODEL, D_MODEL)

    def forward(self, ids):
        return F.linear(torch.tanh(self.proj(self.embed(ids))), self.embed.weight)


def next_token_loss(out, batch):
    return F.cross_entropy(out[:, :-1].flatten(0, 1), batch["tokens"][:, 1:].flatten())


class TrainEntry:
    kind = "train"


MODULES = {
    "reference.tiny_lm": {
        "build": lambda cfg, quant=None: TinyLM(),
        "example_input": lambda cfg, batch, size: torch.zeros(batch, size, dtype=torch.long),
        "model_input": lambda batch: batch["tokens"],
        "loss": next_token_loss,
    },
    "configs.tiny_lm": {"kernel_shapes": lambda cfg, batch, size: {"selective_scan": [(SCAN, 2)]}},
    "entries.tiny_lm_steps": {"Entry": TrainEntry},
}


@pytest.fixture
def cell(monkeypatch) -> Cell:
    for name, attrs in MODULES.items():
        mod = types.ModuleType(name)
        mod.__dict__.update(attrs)
        monkeypatch.setitem(sys.modules, name, mod)
    return Cell.of("tiny_lm.train.s16", "tiny_lm", CFG, TRAFFIC, {"loss1_gap": 1e-6})


def test_rate_follows_the_entry_kind(cell):
    assert {m["name"] for m in cell.end_to_end} == {"train_images_per_s", "peak_mem_gib",
                                                   "setup_s"}
    assert cell.per_layer and all(m["moves"] == "train_images_per_s" for m in cell.per_layer)


@pytest.mark.parametrize("train", [False, True])
def test_model_flops_take_the_token_input(cell, train):
    """The products of the projection and the tied head at (batch, length)
    ids; a training step adds the two products of each in the backward."""
    tokens = BATCH * LENGTH
    forward = 2 * tokens * D_MODEL * (D_MODEL + VOCAB)
    got = work.model_flops(cell.reference(), CFG, BATCH, LENGTH, train)
    assert got == (3 if train else 1) * forward


def test_least_ms_of_the_scan_family(cell):
    import chip_smoke

    shapes, again = cell.kernel_shapes(), cell.recomputed_shapes()
    assert again == {}
    assert work.launches_per_step(shapes, again, True) == {"selective_scan": (2, 2)}
    assert work.launches_per_step(shapes, again, False) == {"selective_scan": (2, 0)}
    B, Dm, L, N, G, bes, streams, const = SCAN
    each = [chip_smoke.bound(*chip_smoke.scan_work(B, Dm, L, N, G, 4, bes, streams, bw,
                                                   const))[0] for bw in (False, True)]
    got = work.least_ms_per_step(shapes, again, 4, True)
    assert set(got) == {"selective_scan"}
    assert got["selective_scan"] == pytest.approx(2 * each[0] + 2 * each[1], rel=1e-12)


def _state_and_batches():
    g = torch.Generator().manual_seed(5)
    state = {n: torch.randn(v.shape, generator=g) * 0.3 for n, v in TinyLM().state_dict().items()}
    batches = [{"tokens": torch.randint(0, VOCAB, (BATCH, LENGTH), generator=g)}
               for _ in range(2)]
    return state, batches


def test_reference_takes_the_models_input_and_loss(cell):
    """The reference's steps and evaluation read `tokens` and take the
    next-token loss: the first step's loss and the evaluation's losses are
    those of the model at the start state."""
    state, batches = _state_and_batches()
    model = TinyLM()
    model.load_state_dict(state)
    with torch.no_grad():
        want = [float(next_token_loss(model(b["tokens"]), b)) for b in batches]
        logits = model(batches[0]["tokens"])
    res = reference_train(cell, state, batches, 0, "cpu")
    assert res["losses"][0] == pytest.approx(want[0], rel=1e-6)
    assert res["losses"][1] != pytest.approx(want[1], rel=1e-6)  # the first step moved it
    assert torch.allclose(res["logits"], logits, rtol=1e-6, atol=1e-6)
    ev = reference_eval(cell, state, dict(enumerate(batches)), "cpu", rows=1)
    assert ev["logits"][0].shape == (BATCH, LENGTH, VOCAB)
    assert [ev["losses"][k] for k in (0, 1)] == pytest.approx(want, rel=1e-6)
