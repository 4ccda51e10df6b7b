"""The port's epoch loops against the JAX package's root `train.py` loops,
on the CPU: a tiny MM_Net (depths (1,1,1,1), num_slices_list (4,4,4,4),
`sideout_drop=0`, remat off) starts from the same weights (the JAX
`create_train_state` init, converted by `mm_net_pairs`) and runs 2 epochs
on `tests/fixtures/drive_mini` at 64², batch 2 (2 steps per epoch), with
config.yml's loss (DiceFocal, smooth_nr 0, smooth_dr 1e-5) and trainer
settings (AdamW at lr 1e-3, warmup 2 epochs, so the first epoch trains at
the warm-up's start lr, 0) and validation after each epoch: the port's
`train_one_epoch` / `val_one_epoch` on its own loaders, in f32, and the
JAX `train.py::train_one_epoch` / `val_one_epoch` (one-device mesh) on the
JAX loaders, which give the same batches (`test_torch_port_loaders.py`).
Dropout is off on both sides: the packages draw their masks from
different generators.

The JAX loops run in float64 (`jax.enable_x64`, the init rounded to f32 for
both packages, the batches cast up; the JAX Mamba keeps its few f32
casts). The trajectory after the first AdamW step is too ill-conditioned
to hold f32 against f32: AdamW's first update is about lr * sign(g), so
every element whose gradient is within rounding of 0 moves by a random
+-lr, and what follows depends on those moves. In a CPU diagnostic (not
kept; another init, warm-up 2 as here) the JAX loop's own f32 trajectory
sat up to 1.7e-4 from its float64 one in a step's loss, 2.9e-2 in a
validation loss and 0.12 in a validation metric (recall), and the port's
f32 within 6e-5, 3.1e-3 and 1.1e-2 of the float64 one.

Held, as max |port - jax| <= tol * (1 + max |jax|), each limit a few times
the reading at this test's init (in brackets):
- the first three steps' losses, before any weight moves, at 1e-5 (1.6e-6);
  the fourth, after one AdamW step at lr 1e-3, at 1e-3 (1.4e-4; 2.4e-5 at
  the diagnostic's init);
- the first epoch's validation losses at 1e-5 (2.5e-7) and metrics at 2e-3
  (0: the same thresholded pixels; one pixel moves f1 by ~2.5e-4); the
  second epoch's, after that step, at 5e-2 (6.2e-3 and 5.7e-3; 1.3e-3 and
  9e-3 at the diagnostic's init).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.data import get_dataloader as jax_get_dataloader
from mm_unet_tpu.models.mm_unet import MM_Net as JMM_Net
from mm_unet_tpu.parallel import make_mesh
from mm_unet_tpu.train.inferers import SlidingWindowInferer as JSlidingWindowInferer
from mm_unet_tpu.train.metrics import build_metrics as jax_build_metrics
from mm_unet_tpu.train.trainer import create_train_state as jax_create_train_state
from mm_unet_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from mm_unet_tpu.utils.torch_convert import mm_net_pairs
from mm_unet_tpu_torch.data import get_dataloader
from mm_unet_tpu_torch.evaluate import val_one_epoch
from mm_unet_tpu_torch.models.mm_unet import MM_Net
from mm_unet_tpu_torch.train.inferers import SlidingWindowInferer
from mm_unet_tpu_torch.train.loop import train_one_epoch
from mm_unet_tpu_torch.train.metrics import build_metrics
from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn
from mm_unet_tpu_torch.utils import ConfigDict
from torch_port_harness import assert_close, load_torch, to_numpy

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(depths=(1, 1, 1, 1), num_slices_list=(4, 4, 4, 4))
LOSS = ({"dice_focal_loss": dict(smooth_nr=0.0, smooth_dr=1e-5)}, {"dice_focal_loss": 1.0})
EPOCHS = 2
STEP_LOSS_TOL = (1e-5, 1e-5, 1e-5, 1e-3)  # per step: the fourth follows the first update
VAL_LOSS_TOL = (1e-5, 5e-2)  # per epoch
METRIC_TOL = (2e-3, 5e-2)  # per epoch


def _config():
    return ConfigDict(
        trainer=dict(num_epochs=EPOCHS, warmup=2, lr=1e-3, optimizer="adamw",
                     weight_decay=0.05, seed=50, dataset_choose="DRIVE"),
        dataset=dict(DRIVE=dict(data_root=str(ROOT / "tests" / "fixtures" / "drive_mini"),
                                batch_size=2, image_size=64,
                                image_mean=[0.485, 0.456, 0.406],
                                image_std=[0.229, 0.224, 0.225])),
        finetune=dict(checkpoint="loop", model_choose="MM_Net"),
    )


class _Recorder:
    """A tracker that keeps every event in memory."""

    def __init__(self):
        self.events = []

    def log(self, scalars, step):
        self.events.append((int(step), {k: float(v) for k, v in scalars.items()}))

    def values(self, key):
        return [e[key] for _, e in self.events if key in e]


def _root_train():
    spec = importlib.util.spec_from_file_location("mmu_root_train", ROOT / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Float64:
    """The JAX loader's batches with the image and label in float64."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for b in self.loader:
            yield {**b, "image": b["image"].astype(np.float64),
                   "label": b["label"].astype(np.float64)}


@pytest.fixture(scope="module")
def runs():
    return _run_both()


def _run_both():
    """(JAX tracker, port tracker, port val metrics, JAX val metrics)."""
    root_train = _root_train()
    jcfg = _config()
    jtrain, jval = jax_get_dataloader(jcfg)
    jcfg.trainer.steps_per_epoch = len(jtrain)
    jm = JMM_Net(mamba_dtype=None, remat=False, sideout_drop=0.0, **TINY)
    jtr, jmetrics = _Recorder(), []
    with jax.enable_x64():
        state = jax_create_train_state(jm, jcfg, jax.random.key(0),
                                       jnp.zeros((2, 3, 64, 64), jnp.float64))
        # both packages start from the init rounded to f32
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32),
            to_numpy({"params": state.params, "batch_stats": state.batch_stats}))
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
        params = f64(variables["params"])
        state = state.replace(params=params, batch_stats=f64(variables["batch_stats"]),
                              opt_state=state.tx.init(params))
        jloss = jax_make_loss_fn(*LOSS)
        jinferer = JSlidingWindowInferer(roi_size=(64, 64), overlap=0.5)
        mesh = make_mesh(devices=jax.devices()[:1])
        step, vstep, rng = 0, 0, jax.random.key(50)
        train_m, val_m = jax_build_metrics(True), jax_build_metrics(True)
        for epoch in range(EPOCHS):
            state, step, rng = root_train.train_one_epoch(
                state, jloss, _Float64(jtrain), train_m, mesh, epoch, step, rng, jcfg,
                tracker=jtr)
            _, metric, vstep = root_train.val_one_epoch(
                state, jloss, jinferer, _Float64(jval), val_m, epoch, vstep, jcfg, tracker=jtr)
            jmetrics.append(metric)
        assert all(p.dtype == jnp.float64 for p in jax.tree_util.tree_leaves(state.params))

    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # small CPU ops; the suite runs several processes at once
    try:
        return (jtr, *_run_port(variables), jmetrics)
    finally:
        torch.set_num_threads(threads)


def _run_port(variables):
    """The port's loops from `variables`: (tracker, val metrics per epoch)."""
    cfg = _config()
    train, val = get_dataloader(cfg)
    cfg.trainer.steps_per_epoch = len(train)
    model = load_torch(MM_Net(mamba_dtype=None, remat=False, sideout_drop=0.0, **TINY),
                       variables, mm_net_pairs(depths=TINY["depths"]))
    pstate = create_train_state(model, cfg, seed=50)
    loss_fn = make_loss_fn(*LOSS)
    inferer = SlidingWindowInferer(roi_size=(64, 64), overlap=0.5)
    ptr, pmetrics = _Recorder(), []
    vstep = 0
    train_m, val_m = build_metrics(True), build_metrics(True)
    for epoch in range(EPOCHS):
        train_one_epoch(pstate, loss_fn, train, train_m, epoch, EPOCHS, tracker=ptr)
        _, metric, losses = val_one_epoch(model, loss_fn, inferer, val, val_m, epoch, EPOCHS,
                                          vstep, ptr)
        vstep += len(losses)
        pmetrics.append(metric)
    return ptr, pmetrics


def test_step_losses_match_jax_loop(runs):
    want, got = runs[0].values("Train/total_loss"), runs[1].values("Train/total_loss")
    assert len(want) == len(got) == 2 * EPOCHS
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, STEP_LOSS_TOL[i], f"step {i} loss")


@pytest.mark.parametrize("epoch", range(EPOCHS))
def test_val_losses_match_jax_loop(runs, epoch):
    want, got = runs[0].values("Val/total_loss"), runs[1].values("Val/total_loss")
    assert len(want) == len(got) == 2 * EPOCHS  # two val images per epoch
    assert_close(got[2 * epoch:2 * epoch + 2], want[2 * epoch:2 * epoch + 2],
                 VAL_LOSS_TOL[epoch], f"epoch {epoch} val losses")


@pytest.mark.parametrize("epoch", range(EPOCHS))
def test_val_metrics_match_jax_loop(runs, epoch):
    got, want = runs[2][epoch], runs[3][epoch]
    assert set(got) == set(want)
    for k, w in want.items():
        assert_close(got[k], w, METRIC_TOL[epoch], k)


def test_tracker_steps_match_jax_loop(runs):
    """The same events at the same steps: per-step scalars, the epoch's
    train metrics, per-batch val losses and the val metrics."""
    jtr, ptr = runs[:2]
    assert [(s, sorted(e)) for s, e in ptr.events] == [(s, sorted(e)) for s, e in jtr.events]
