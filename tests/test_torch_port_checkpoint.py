"""The port's checkpoints against the JAX package's, on the CPU.

`CheckpointManager` keeps the JAX package's layout (`<root>/<name>/best`,
`checkpoint`, `<tag>_meta.json` with the same keys and contents); a save and
a load restore the train state bit for bit (the model's parameters and
BatchNorm statistics, the AdamW state, the step count, the dropout
generator); `resume_train_state` restarts at epoch 0 with the JAX
package's message on a corrupt or mismatched file and leaves the state as
it was; and the port MM_Net's `param_manifest` maps one to one onto
`tests/fixtures/mmnet_param_manifest.json` (the JAX MM_Net's) through
`mm_net_pairs`, each shape the converted flax shape.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from mm_unet_tpu.utils.torch_convert import mm_net_pairs
from mm_unet_tpu_torch.models.mm_unet import MM_Net
from mm_unet_tpu_torch.train.checkpoint import (
    CheckpointManager,
    param_manifest,
    resume_train_state,
)
from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn, train_step
from mm_unet_tpu_torch.utils.convert import jax_to_torch_state_dict

MANIFEST = Path(__file__).resolve().parent / "fixtures" / "mmnet_param_manifest.json"
TINY = dict(depths=(1, 1, 1, 1), num_slices_list=(4, 4, 4, 4))
CONFIG = {"trainer": dict(lr=1e-3, warmup=1, num_epochs=4, steps_per_epoch=2,
                          weight_decay=0.05, optimizer="adamw")}
META = {"epoch": 3, "best_acc": 0.25, "best_class": {"Val/mean f1": 0.25,
                                                      "Val/mean precision": float("nan")}}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: these small CPU ops gain little from more, and
    the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _state(seed: int, steps: int = 0):
    """A tiny MM_Net's train state after `steps` train steps on seeded data
    (dropout on, so the generator's state moves too)."""
    model = MM_Net(mamba_dtype=None, generator=torch.Generator().manual_seed(seed), **TINY)
    state = create_train_state(model, CONFIG, seed=seed)
    rng = np.random.default_rng(seed)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    for _ in range(steps):
        x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(np.float32))
        y = torch.from_numpy((rng.random((2, 1, 64, 64)) < 0.3).astype(np.float32))
        train_step(state, x, y, loss_fn)
    return state


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b or (a != a and b != b)


def _snapshot(state):
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "optimizer": state.optimizer.state_dict(), "step": state.step,
            "generator": state.generator.get_state()}


def _matches(state, snap) -> bool:
    return (_same(state.model.state_dict(), snap["model"])
            and _same(state.optimizer.state_dict(), snap["optimizer"])
            and state.step == snap["step"]
            and _same(state.generator.get_state(), snap["generator"]))


def test_save_and_load_round_trip_bit_for_bit(tmp_path):
    saved = _state(1, steps=1)
    snap = _snapshot(saved)
    manager = CheckpointManager(str(tmp_path), "run")
    manager.save_checkpoint(saved, META)
    assert manager.has("checkpoint") and not manager.has("best")
    fresh = _state(2)
    assert not _matches(fresh, snap)
    meta = manager.load("checkpoint", fresh)
    assert _matches(fresh, snap) and fresh.step == 1
    assert meta["epoch"] == 3 and meta["best_acc"] == 0.25
    # the restored state trains on exactly as the saved one does
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 1, 64, 64)) < 0.3).astype(np.float32))
    a, _ = train_step(saved, x, y, loss_fn)
    b, _ = train_step(fresh, x, y, loss_fn)
    assert a["total_loss"].item() == b["total_loss"].item()
    assert _same(saved.model.state_dict(), fresh.model.state_dict())


def test_model_only_load_keeps_the_optimizer(tmp_path):
    saved = _state(1, steps=1)
    manager = CheckpointManager(str(tmp_path), "run")
    manager.save_best(saved, META)
    fresh = _state(2)
    opt, gen = fresh.optimizer.state_dict(), fresh.generator.get_state()
    manager.load("best", fresh, model_only=True)
    assert _same(fresh.model.state_dict(), saved.model.state_dict())
    assert _same(fresh.optimizer.state_dict(), opt) and fresh.step == 0
    assert _same(fresh.generator.get_state(), gen)


def test_layout_and_metadata_match_jax(tmp_path):
    """The same files under model_store/<name>/ and the same metadata JSON
    as the JAX package's orbax checkpoints."""
    jmanager = JCheckpointManager(str(tmp_path / "jax"), "run")
    jtree = {"params": {"w": jnp.ones((2, 2))}}
    manager = CheckpointManager(str(tmp_path / "port"), "run")
    state = _state(1)
    for tag in ("best", "checkpoint"):
        getattr(jmanager, f"save_{tag}")(jtree, META)
        getattr(manager, f"save_{tag}")(state, META)
    jfiles = sorted(p.name for p in (tmp_path / "jax" / "run").iterdir())
    files = sorted(p.name for p in (tmp_path / "port" / "run").iterdir())
    assert files == jfiles == ["best", "best_meta.json", "checkpoint", "checkpoint_meta.json"]
    for name in ("best_meta.json", "checkpoint_meta.json"):
        got = (tmp_path / "port" / "run" / name).read_text()
        assert got == (tmp_path / "jax" / "run" / name).read_text()
        assert set(json.loads(got)) == {"epoch", "best_acc", "best_class"}
    _, jmeta = jmanager.load("best", jtree)
    assert _same(manager.load("best", _state(2)), jmeta)


@pytest.mark.parametrize("fault", ["corrupt", "other_model", "missing"])
def test_failed_resume_starts_fresh_with_the_message(tmp_path, capsys, fault):
    manager = CheckpointManager(str(tmp_path), "run")
    if fault == "corrupt":
        (tmp_path / "run" / "checkpoint").write_bytes(b"not a checkpoint")
    elif fault == "other_model":
        other = MM_Net(mamba_dtype=None, num_slices_list=(4, 4, 4, 4), depths=(1, 1, 1, 2))
        manager.save_checkpoint(create_train_state(other, CONFIG), META)
    state = _state(3)
    snap = _snapshot(state)
    assert resume_train_state(manager, state) == (0, 0.0, {})
    out = capsys.readouterr().out
    assert "resume failed (" in out and out.rstrip().endswith("; starting from epoch 0")
    assert _matches(state, snap)


def test_resume_returns_the_saved_epoch(tmp_path):
    manager = CheckpointManager(str(tmp_path), "run")
    manager.save_checkpoint(_state(1, steps=1), META)
    state = _state(2)
    epoch, best_acc, meta = resume_train_state(manager, state)
    assert (epoch, best_acc) == (3, 0.25) and meta["best_class"]["Val/mean f1"] == 0.25
    assert state.step == 1


def test_mm_net_manifest_maps_onto_the_jax_fixture():
    """One to one: every fixture entry and every port entry is one pair of
    `mm_net_pairs`, and each port shape is the fixture's flax shape in
    torch layout (the converter's inverse of the pair's kind)."""
    want = json.loads(MANIFEST.read_text())
    model = MM_Net(mamba_dtype=None, num_slices_list=(4, 4, 2, 2), depths=(1, 1, 1, 1))
    got = param_manifest(model)
    pairs = mm_net_pairs(depths=(1, 1, 1, 1))

    def fixture_key(fpath):
        return ("batch_stats/" if fpath[-1] in ("mean", "var") else "params/") + "/".join(fpath)

    fkeys = [fixture_key(fp) for fp, _, _ in pairs]
    tkeys = [tk for _, tk, _ in pairs]
    assert len(set(fkeys)) == len(set(tkeys)) == len(pairs) == len(want) == len(got)
    assert set(fkeys) == set(want) and set(tkeys) == set(got)
    # a flax tree of zeros with the fixture's shapes, through the converter
    tree: dict = {}
    for key, shape in want.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.zeros(shape, np.float32)
    converted = jax_to_torch_state_dict(tree, pairs)
    assert {k: list(v.shape) for k, v in converted.items()} == got
    assert all(not k.endswith("num_batches_tracked") for k in got)
