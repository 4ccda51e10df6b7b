"""The port's tensor parallelism of the Mamba mixer (`mm_unet_tpu_torch/
parallel/tp.py`) against the JAX package's (`tests/test_tp.py`), on the
CPU: the ported `MicroMambaNet` (a tri-directional Mamba on the
grouped-scan route) takes one train step with its Mamba split over a
2-rank `model` group, and on a 2 data x 2 model grid (4 gloo ranks), each
against JAX's `shard_params` step on a mesh of the same shape (virtual CPU
devices). The JAX test runs (data 4, model 2); 8 gloo ranks would cost
too much test time. Also: the rules split exactly the parameters the JAX
rules split, each along the same dimension, read on the port's names.

Tolerances are `tests/test_tp.py`'s: loss rtol 1e-5; parameters after the
step rtol 1e-3, atol 1e-5, the dt_proj weights moved by the stated term
(the JAX package decays its shifted storage, w + dt_rank**-0.5, the port
the torch weight: after one step they differ by lr * wd * dt_rank**-0.5).
"""

import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mm_unet_tpu.parallel import make_mesh, replicate, shard_batch, shard_params
from mm_unet_tpu.parallel.tp import tp_param_specs as jax_tp_param_specs
from mm_unet_tpu.train.trainer import create_train_state, make_loss_fn, train_step
from mm_unet_tpu.utils.config import ConfigDict
from mm_unet_tpu.utils.torch_convert import conv_pairs, mamba_pairs
from mm_unet_tpu_torch.parallel.tp import MAMBA_TP_RULES, local_slice, spec_for, tp_param_specs
from mm_unet_tpu_torch.utils.convert import jax_to_torch_state_dict
from test_torch_port_ranks import MicroMambaNet, run_ranks, tp_worker
from test_tp import MicroMambaNet as JMicroMambaNet
from torch_port_harness import to_numpy

PAIRS = (conv_pairs(("Conv_0",), "stem") + mamba_pairs(("Mamba_0",), "mamba", 16)
         + conv_pairs(("Conv_1",), "head"))
LR, WD = 1e-3, 0.05
_DT_PROJ = re.compile(r"dt_proj(_[bs])?\.weight$")


def _jax_state(x):
    """A fresh JAX train state (its step donates the one it is given)."""
    config = ConfigDict(trainer=dict(lr=LR, warmup=1, num_epochs=10, weight_decay=WD,
                                     steps_per_epoch=1, optimizer="adamw", flat_optimizer=False))
    return create_train_state(JMicroMambaNet(), config, jax.random.key(0), x[:2])


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 16, 16)).astype(np.float32)
    y = (rng.random((4, 1, 16, 16)) > 0.8).astype(np.float32)
    state = _jax_state(x)
    sd = {k: v.numpy() for k, v in jax_to_torch_state_dict(
        to_numpy({"params": state.params}), PAIRS, like=MicroMambaNet().state_dict()).items()}
    return x, y, sd, to_numpy(state.params)


def _jax_step(x, y, data, model):
    state = _jax_state(x)
    mesh = make_mesh(("data", "model"), shape=(data, model), devices=jax.devices()[:data * model])
    st = state.replace(params=shard_params(state.params, mesh),
                       batch_stats=replicate(state.batch_stats, mesh),
                       opt_state=shard_params(state.opt_state, mesh))
    assert st.params["Mamba_0"]["in_proj_weight"].sharding.spec == P("model", None)
    sb, w = shard_batch({"image": x, "label": y}, mesh)
    new, scalars, _ = train_step(st, sb["image"], sb["label"], jax.random.key(7),
                                 make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0}),
                                 sample_weight=w)
    return float(scalars["total_loss"]), {k: v.numpy() for k, v in jax_to_torch_state_dict(
        to_numpy({"params": new.params}), PAIRS).items()}


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_tp_step_matches_jax(setup, tmp_path, data, model):
    x, y, sd, _ = setup
    got = run_ranks(data * model, tp_worker, tmp_path, sd, x, y, data, model)
    want_loss, want = _jax_step(x, y, data, model)
    d_inner = 32
    for r, res in enumerate(got):
        assert res["local_in_proj"] == (2 * d_inner // model, 16)  # the rank's x and z rows
        np.testing.assert_allclose(res["loss"], want_loss, rtol=1e-5)
        assert set(res["params"]) == set(want)
        for k, v in want.items():
            if _DT_PROJ.search(k):
                v = v + LR * WD * v.shape[1] ** -0.5
            np.testing.assert_allclose(res["params"][k], v, rtol=1e-3, atol=1e-5,
                                       err_msg=f"{k}, rank {r}")


def test_tp_rules_match_jax_on_port_names(setup):
    """Every parameter the JAX rules split, the port's split along the same
    dimension (read through the pair table), at 2 and at 3 shards (3 does
    not divide d_inner 32: everything falls back to replication)."""
    *_, params = setup
    tnames = {tk: fp for fp, tk, _ in PAIRS}
    for n in (2, 3):
        mesh = make_mesh(("data", "model"), shape=(8 // n if n == 2 else 1, n),
                         devices=jax.devices()[:8 if n == 2 else 3])
        jspecs = {tuple(k.key for k in path): spec for path, spec in
                  jax.tree_util.tree_leaves_with_path(
                      jax_tp_param_specs(params, mesh),
                      is_leaf=lambda s: isinstance(s, P))}
        port = tp_param_specs(MicroMambaNet(), n)
        assert set(port) == set(tnames)
        for name, dim in port.items():
            spec = tuple(jspecs[tuple(tnames[name])])
            jdim = spec.index("model") if "model" in spec else None
            assert dim == jdim, (name, n, dim, spec)
        n_split = sum(d is not None for d in port.values())
        assert n_split == (3 * 7 + 2 if n == 2 else 0), n_split


def test_in_proj_split_keeps_x_and_z_channels_together():
    t = torch.arange(8.0)[:, None].repeat(1, 3)  # rows 0-3: x, 4-7: z
    assert local_slice(t, "mamba.in_proj.weight", 0, 1, 2)[:, 0].tolist() == [2, 3, 6, 7]
    assert local_slice(t, "mamba.out_proj.weight", 0, 1, 2)[:, 0].tolist() == [4, 5, 6, 7]
    assert spec_for("mamba.D_s", (32,), 2) == 0 and spec_for("head.weight", (1, 16), 2) is None
    assert len(MAMBA_TP_RULES) == 10
