"""One whole train step of UM_Net, the port against the JAX `train_step` on
the CPU: 2x3x64x64, DiceFocal with per-sample weights, AdamW at lr 1e-3,
the JAX weights and random BatchNorm running statistics carried across by
`um_net_pairs`. Compared: the loss, every parameter gradient (read back
through `jax_grads_to_torch`), the updated BatchNorm statistics and the
parameters after the step. One JAX init and one compiled JAX step serve the
file (module-scoped fixture); a file of its own, so that `--dist loadfile`
puts its compile beside the eval test's.

The JAX step runs in float64 (`jax.enable_x64`, the f32 init's weights and
the batch cast up; the JAX Mamba keeps its few f32 casts), the port in f32.
This train step is ill-conditioned: a random-init ResNet-34 in train mode
with batch statistics over 8 values per channel at its 2x2 stage, where a
1e-7 relative change of the input moves float64 gradients by up to 2e-3.
So f32 rounding alone moves gradients by up to ~5e-3 of their tensor's
scale, and the JAX step's own f32 run sits up to 0.13 from its float64 one
(median 4.7e-4); the port's f32 step sits within 4.8e-3 of it (median
8e-5). An f32-to-f32 comparison would measure the two packages' rounding,
not the port. Relative to each tensor's own largest gradient the port's
step reads up to 0.06, and 0.39 on `rcg4.mlp.0.bias` (one element, a sum
over the 2x2 stage that cancels to 2e-6), besides the gradients that are
zero in exact arithmetic: too close to a zeroed gradient's 1 to gate here.
Each gradient is held to its own tensor, at 1e-4, by
`test_torch_port_umnet.py::test_block_gradients_match_jax`, block by block
in eval mode, where nothing is ill-conditioned.

Dropout is off on both sides, in this file only: UM_Net's rate is fixed at
0.1 and the two packages draw their masks from different generators. The
JAX side runs with flax's `nn.Dropout.__call__` patched to the identity,
the port with p = 0 on each Dropout2d. The port's dropout sites and rate
are checked on their own.

Tolerances, as max |port - jax| <= tol * (1 + max |jax|): loss 1e-5,
gradients 1e-2 (the conditioning above), BatchNorm statistics 1e-4,
parameters 1e-5 at every element whose gradient is clear of 0 by more than
the gradient tolerance (AdamW's first update is about lr * sign(g), as in
test_torch_port_train.py). The dt_proj weights differ by the stated
weight-decay term (ROADMAP.md queue 3).
"""

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.models.um_net import UM_Net as JUM_Net
from mm_unet_tpu.train.optim import build_optimizer as jax_build_optimizer
from mm_unet_tpu.train.optim import warmup_cosine_epoch_schedule as jax_schedule
from mm_unet_tpu.train.trainer import TrainState as JTrainState
from mm_unet_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from mm_unet_tpu.train.trainer import train_step as jax_train_step
from mm_unet_tpu.utils.torch_convert import um_net_pairs
from mm_unet_tpu_torch.models import give_model
from mm_unet_tpu_torch.models.layers import Dropout2d
from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn, train_step
from mm_unet_tpu_torch.utils.convert import jax_grads_to_torch, jax_to_torch_state_dict
from torch_port_harness import (assert_close, load_torch, randomize_batch_stats, record_grads,
                                to_numpy)

PAIRS = um_net_pairs()
CONFIG = {"trainer": dict(lr=1e-3, warmup=1, num_epochs=10, weight_decay=0.05,
                          steps_per_epoch=1, optimizer="adamw")}
GRAD_TOL = 1e-2
_DT_PROJ = re.compile(r"(^|\.)dt_proj(_b|_s)?\.weight$")


@pytest.fixture(scope="module")
def jax_step():
    """(variables before, after one JAX train_step, loss, gradients, batch)
    as numpy, with flax's Dropout the identity while the step is traced."""
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    y = (rng.random((2, 1, 64, 64)) < 0.2).astype(np.float32)
    weight = np.array([1.0, 0.5], np.float32)
    jm = JUM_Net()
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = randomize_batch_stats(variables, np.random.default_rng(21))
    lr = CONFIG["trainer"]
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64():
        mp.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
        f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
        params = jax.tree_util.tree_map(f64, variables["params"])
        schedule = jax_schedule(lr["lr"], lr["warmup"], lr["num_epochs"], lr["steps_per_epoch"])
        tx = record_grads(jax_build_optimizer(params, lr=schedule,
                                              weight_decay=lr["weight_decay"]))
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                            batch_stats=jax.tree_util.tree_map(f64, variables["batch_stats"]),
                            opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
        loss_fn = jax_make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
        new, scalars, _ = jax_train_step(state, f64(x), f64(y), jax.random.PRNGKey(1), loss_fn,
                                         sample_weight=f64(weight))
        assert scalars["total_loss"].dtype == jnp.float64
        after = to_numpy({"params": new.params, "batch_stats": new.batch_stats})
        grads = to_numpy(new.opt_state[1])
    f32 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return variables, f32(after), float(scalars["total_loss"]), f32(grads), (x, y, weight)


def test_um_net_train_step_matches_jax(jax_step):
    variables, after, want_loss, jgrads, (x, y, weight) = jax_step
    model = load_torch(give_model("UM_Net", device="cpu"), variables, PAIRS)
    drops = [m for m in model.modules() if isinstance(m, Dropout2d)]
    for m in drops:
        m.p = 0.0
    state = create_train_state(model, CONFIG)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    scalars, _ = train_step(state, torch.from_numpy(x), torch.from_numpy(y), loss_fn,
                            sample_weight=torch.from_numpy(weight))
    assert state.step == 1 and model.training
    assert_close(scalars["total_loss"].item(), want_loss, 1e-5, "loss")
    want_grads = jax_grads_to_torch(jgrads, PAIRS)
    named = dict(model.named_parameters())
    assert set(want_grads) == set(named)
    settled = {}
    for k, g in want_grads.items():
        assert_close(named[k].grad.numpy(), g.numpy(), GRAD_TOL, f"grad {k}")
        g = g.numpy()
        settled[k] = np.abs(g) > GRAD_TOL * (1.0 + np.abs(g).max())
    assert sum(int(m.sum()) for m in settled.values()) > 0.5 * sum(
        m.size for m in settled.values())
    sd = model.state_dict()
    for k, v in jax_to_torch_state_dict(after, PAIRS).items():
        if _DT_PROJ.search(k):
            v = v + 1e-3 * 0.05 * v.shape[1] ** -0.5  # the stated weight-decay term
        if k.endswith(("running_mean", "running_var")):
            assert_close(sd[k].numpy(), v.numpy(), 1e-4, k)
        elif settled[k].any():
            m = settled[k]
            assert_close(sd[k].numpy()[m], v.numpy()[m], 1e-5, k)


def test_um_net_dropout_sites_and_rate():
    """Channel dropout at rate 0.1 after each side output's DSConv-BN-ReLU
    and in the final head (the JAX model's two `Dropout(0.1,
    broadcast_dims=(1, 2))` sites), drawn from the generator that
    `set_dropout_generator` gives every site; off in eval mode."""
    model = give_model("UM_Net", device="cpu")
    sites = {name: m.p for name, m in model.named_modules() if isinstance(m, Dropout2d)}
    assert sites == {**{f"side{n}.drop": 0.1 for n in (5, 4, 3, 2)}, "final.3": 0.1}
    g = torch.Generator().manual_seed(3)
    model.set_dropout_generator(g)
    assert all(m.generator is g for m in model.modules() if isinstance(m, Dropout2d))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 3, 64, 64), np.float32))
    with torch.no_grad():
        model.train()
        g.manual_seed(5)
        a = model(x)
        g.manual_seed(5)
        b = model(x)
        g.manual_seed(6)
        c = model(x)
        e1, e2 = model.eval()(x), model(x)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(e1, e2)
