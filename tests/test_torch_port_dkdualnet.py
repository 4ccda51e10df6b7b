"""The port's dkDualNet against the JAX package, on the CPU, on both of the
Mambas' routes (the megakernel's plain version and the grouped scan's): the
eval logits, and one whole train step (DiceFocal, backward, AdamW) with the
loss, every parameter gradient, the updated BatchNorm statistics and the
parameters after the step. Plus the registry entry, the launch counts and
the default device of `give_model`.

The model is dkDualNet(dims=(16,32,64,128), depths=(1,1,1,1)) at 2x3x64x64,
f32, drop_path_rate=0, with the JAX weights carried across by
`dkdualnet_pairs` (the second LayerNorm and layer_scale of each DLKBlock
renamed, `torch_port_harness.dkdualnet_port_pairs`), random BatchNorm
running statistics, and random layer scales (at their 1e-6 init the DLK
branches would hardly count). One JAX init and one compiled JAX step serve
the file.

Tolerances, as max |port - jax| <= tol * (1 + max |jax|): logits 5e-4 and
the step's gradients 2e-4 (summation orders through ~60 layers forward and
back), loss 1e-5, BatchNorm statistics 1e-4, parameters after the step 1e-5
at every element whose gradient is clear of 0 by more than the gradient
tolerance (as in test_torch_port_train.py). The dt_proj weights differ by
the stated weight-decay term (ROADMAP.md queue 3).
"""

import inspect
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.models.dkdualnet import dkDualNet as JdkDualNet
from mm_unet_tpu.train.optim import build_optimizer as jax_build_optimizer
from mm_unet_tpu.train.optim import warmup_cosine_epoch_schedule as jax_schedule
from mm_unet_tpu.train.trainer import TrainState as JTrainState
from mm_unet_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from mm_unet_tpu.train.trainer import train_step as jax_train_step
from mm_unet_tpu_torch.models import give_model
from mm_unet_tpu_torch.models.dkdualnet import dkDualNet
from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn, train_step
from mm_unet_tpu_torch.utils.convert import jax_grads_to_torch, jax_to_torch_state_dict
from torch_port_harness import (
    assert_close,
    dkdualnet_port_pairs,
    load_torch,
    randomize_batch_stats,
    record_grads,
    to_numpy,
)

TINY = dict(dims=(16, 32, 64, 128), depths=(1, 1, 1, 1))
PAIRS = dkdualnet_port_pairs(**TINY)
CONFIG = {"trainer": dict(lr=1e-3, warmup=1, num_epochs=10, weight_decay=0.05,
                          steps_per_epoch=1, optimizer="adamw")}
GRAD_TOL = 2e-4
_DT_PROJ = re.compile(r"(^|\.)dt_proj(_b|_s)?\.weight$")


@pytest.fixture(scope="module")
def jax_step():
    """(variables, logits in eval mode, after one JAX train_step, loss,
    gradients, batch) as numpy."""
    from mm_unet_tpu.utils.config import ConfigDict

    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    y = (rng.random((2, 1, 64, 64)) < 0.2).astype(np.float32)
    jm = JdkDualNet(drop_path_rate=0.0, **TINY)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = randomize_batch_stats(variables, np.random.default_rng(21))
    for name, block in variables["params"].items():
        if name.startswith("DLKBlock_"):
            for k in ("layer_scale", "layer_scale2"):
                block[k] = rng.uniform(0.5, 1.5, block[k].shape).astype(np.float32)
    logits = np.asarray(jax.jit(lambda v, xj: jm.apply(v, xj, train=False))(
        variables, jnp.asarray(x)))
    tcfg = ConfigDict(CONFIG).trainer
    schedule = jax_schedule(tcfg.lr, tcfg.warmup, tcfg.num_epochs, tcfg.steps_per_epoch)
    tx = record_grads(jax_build_optimizer(variables["params"], lr=schedule,
                                          weight_decay=tcfg.weight_decay))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                        opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
    loss_fn = jax_make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    new, scalars, _ = jax_train_step(state, jnp.asarray(x), jnp.asarray(y),
                                     jax.random.PRNGKey(1), loss_fn)
    after = to_numpy({"params": new.params, "batch_stats": new.batch_stats})
    return (variables, logits, after, float(scalars["total_loss"]), to_numpy(new.opt_state[1]),
            (x, y))


def _port(variables, scan_impl):
    return load_torch(dkDualNet(drop_path_rate=0.0, scan_impl=scan_impl, **TINY), variables,
                      PAIRS)


@pytest.mark.parametrize("scan_impl", [None, "pallas"])
def test_dkdualnet_eval_matches_jax(jax_step, scan_impl):
    variables, want, *_, (x, _) = jax_step
    model = _port(variables, scan_impl)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 1, 64, 64)
    assert_close(got.numpy(), want, 5e-4, f"dkDualNet logits ({scan_impl})")


@pytest.mark.parametrize("scan_impl", [None, "pallas"])
def test_dkdualnet_train_step_matches_jax(jax_step, scan_impl):
    variables, _, after, want_loss, jgrads, (x, y) = jax_step
    model = _port(variables, scan_impl)
    state = create_train_state(model, CONFIG)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    scalars, _ = train_step(state, torch.from_numpy(x), torch.from_numpy(y), loss_fn)
    assert state.step == 1
    assert_close(scalars["total_loss"].item(), want_loss, 1e-5, "loss")
    want_grads = jax_grads_to_torch(jgrads, PAIRS)
    named = dict(model.named_parameters())
    assert set(want_grads) == set(named)
    settled = {}  # per parameter: elements whose gradient is clear of 0
    for k, g in want_grads.items():
        assert_close(named[k].grad.numpy(), g.numpy(), GRAD_TOL, f"grad {k}")
        g = g.numpy()
        settled[k] = np.abs(g) > GRAD_TOL * (1.0 + np.abs(g).max())
    # the parameters after the step are held where the gradient is clear of 0
    # (17% of the elements at this seed: most of the wide layers' gradients
    # are small next to each tensor's largest); the rest through the gradients
    assert sum(int(m.sum()) for m in settled.values()) > 0.1 * sum(
        m.size for m in settled.values())
    sd = model.state_dict()
    for k, v in jax_to_torch_state_dict(after, PAIRS).items():
        if _DT_PROJ.search(k):
            # the JAX package decays its stored dt_proj weight, w + dt_rank**-0.5
            v = v + 1e-3 * 0.05 * v.shape[1] ** -0.5
        if k.endswith(("running_mean", "running_var")):
            assert_close(sd[k].numpy(), v.numpy(), 1e-4, k)
        elif settled[k].any():
            assert_close(sd[k].numpy()[settled[k]], v.numpy()[settled[k]], 1e-5, k)


def test_dkdualnet_registry_and_launch_counts():
    """give_model builds dkDualNet with the JAX constructor's kwargs; at full
    width a forward runs six v2 Mambas: 12 megakernel launches on route a,
    6 grouped-scan launches on route b, and as many backward launches."""
    m = give_model("dkDualNet", device="cpu", generator=torch.Generator().manual_seed(1),
                   scan_impl="pallas", drop_path_rate=0.1, out_channels=2, **TINY)
    assert isinstance(m, dkDualNet) and not m.training and m.scan_impl == "pallas"
    assert m.head.out_channels == 2
    assert [b.drop_path.p for s in m.dnet_down.stages for b in s] == pytest.approx(
        [0.0, 0.1 / 3, 0.2 / 3, 0.1])
    full = dkDualNet()
    assert full.kernel_launches_per_forward() == {"mamba_fused_scan": 12}
    assert full.kernel_launches_per_train_step() == {"mamba_fused_scan": {"fwd": 12, "bwd": 12}}
    full.scan_impl = "pallas"
    assert full.kernel_launches_per_train_step() == {"selective_scan": {"fwd": 6, "bwd": 6}}


def test_give_model_defaults_to_the_card(monkeypatch):
    """The entry point runs on the card unless the caller asks for the CPU;
    without a card the default raises and says how to ask."""
    assert inspect.signature(give_model).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("MM_Net", "dkDualNet"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            give_model(name)
    assert next(give_model("dkDualNet", device="cpu", **TINY).parameters()).device.type == "cpu"


def test_slice_modules_never_import_jax():
    code = (
        "import sys\n"
        "import mm_unet_tpu_torch.models.dkdualnet, mm_unet_tpu_torch.models.registry\n"
        "import mm_unet_tpu_torch.ops.selective_scan, mm_unet_tpu_torch.ops.chunked_scan\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'mm_unet_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
