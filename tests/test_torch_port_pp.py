"""The port's pipeline parallelism (`mm_unet_tpu_torch/parallel/pp.py`)
against the JAX package's (`mm_unet_tpu/parallel/pp.py`) and against the
port's sequential forward, on the CPU: 2 stages (gloo ranks spawned by
`test_torch_port_ranks.run_ranks`), 2 and 4 microbatches, a 4-layer
MixerModel at `tests/test_pp.py`'s widths (d_model 16, d_state 4, vocab
32) with the JAX init's weights.

- `mixer_pipeline_forward`: the output on both stages and every gradient
  (each Block's from the stage that holds it, the embedding's from stage 0,
  norm_f's from both) against JAX's `mixer_pipeline_forward` on a `stage`
  mesh of 2 virtual devices, and against the port's `MixerModel` run
  straight through. The port's norm_f is set to the JAX model's eps 1e-6
  for the comparison (the port keeps the reference's 1e-5).
- `pipeline_apply` of a plain tensor through four tanh layers: output and
  gradients (the input's on stage 0) against the layers run in order.

Tolerances, as max |port - ref| <= tol * (1 + max |ref|): against JAX
2e-5 (values) and 1e-4 (gradients: the token-by-token scan against JAX's
associative one, through four Blocks); against the port's own sequential
forward 1e-6 (the same arithmetic per microbatch; only the gradients'
sums over the microbatches change order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.models.lm import MixerModel as JMixerModel
from mm_unet_tpu.parallel import make_mesh
from mm_unet_tpu.parallel import mixer_pipeline_forward as jax_mixer_pipeline_forward
from mm_unet_tpu_torch.utils.convert import jax_grads_to_torch, jax_to_torch_state_dict, lm_pairs
from test_torch_port_ranks import PP_LM, pp_lm, pp_mlp, pp_worker, run_ranks
from torch_port_harness import assert_close, sub_pairs, to_numpy

MICROBATCHES = (2, 4)
PAIRS = sub_pairs(("backbone",), "backbone.", lm_pairs(PP_LM["n_layer"], PP_LM["d_model"], False))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, PP_LM["vocab_size"], (4, 8)).astype(np.int64)
    jm = JMixerModel(**PP_LM)
    v = to_numpy(jm.init(jax.random.key(0), jnp.asarray(ids, jnp.int32)))
    state = {k: t.numpy() for k, t in jax_to_torch_state_dict(
        v, PAIRS, like=pp_lm().state_dict()).items()}
    w = rng.standard_normal((4, 8, PP_LM["d_model"])).astype(np.float32)
    xs = rng.standard_normal((4, 8)).astype(np.float32)
    ws = rng.standard_normal((4, 8)).astype(np.float32)
    got = run_ranks(2, pp_worker, tmp_path_factory.mktemp("pp"), state, ids, w, xs, ws,
                    MICROBATCHES)
    return jm, v, state, ids, w, xs, ws, got


def _merge(stages) -> dict:
    """Each parameter's gradient from the stage that holds it (a Block's
    from its stage, the embedding's from stage 0, norm_f's from any)."""
    out = {}
    for s in stages:
        for k, g in s["grads"].items():
            out.setdefault(k, g)
    return out


@pytest.mark.parametrize("m", range(len(MICROBATCHES)), ids=[f"M{m}" for m in MICROBATCHES])
def test_mixer_pipeline_matches_jax(run, m):
    jm, v, _, ids, w, *_, got = run
    M = MICROBATCHES[m]
    mesh = make_mesh(("stage",), devices=jax.devices()[:2])

    def loss(params):
        out = jax_mixer_pipeline_forward(jm, {"params": params}, jnp.asarray(ids, jnp.int32),
                                         mesh=mesh, num_microbatches=M)
        return jnp.sum(out * w), out

    (_, want_y), want_g = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, v["params"]))
    want_g = {k: t.numpy() for k, t in jax_grads_to_torch(to_numpy(want_g), PAIRS).items()}
    stages = [g[m] for g in got]
    for s in stages:  # every stage returns the output
        assert_close(s["y"], np.asarray(want_y), 2e-5, f"M={M} output")
    grads = _merge(stages)
    assert set(grads) == set(want_g)
    for k, g in want_g.items():
        assert_close(grads[k], g, 1e-4, f"M={M} grad {k}")
    held = [{k.split(".")[1] for k in s["grads"] if k.startswith("layers.")} for s in stages]
    assert held == [{"0", "1"}, {"2", "3"}]  # contiguous layer groups
    assert "embedding.weight" not in stages[1]["grads"]  # stage 0 alone reads the ids


@pytest.mark.parametrize("m", range(len(MICROBATCHES)), ids=[f"M{m}" for m in MICROBATCHES])
def test_pipeline_matches_sequential(run, m):
    _, _, state, ids, w, xs, ws, got = run
    stages = [g[m] for g in got]
    model = pp_lm(state)
    y = model(torch.from_numpy(ids))
    (y * torch.from_numpy(w)).sum().backward()
    for s in stages:
        assert_close(s["y"], y.detach().numpy(), 1e-6, "mixer output")
    grads = _merge(stages)
    for k, p in model.named_parameters():
        assert_close(grads[k], p.grad.numpy(), 1e-6, f"grad {k}")
    mlp = pp_mlp()
    x = torch.from_numpy(xs).requires_grad_()
    z = x
    for layer in mlp:
        z = layer(z)
    (z * torch.from_numpy(ws)).sum().backward()
    for s in stages:
        assert_close(s["z"], z.detach().numpy(), 1e-6, "pipeline_apply output")
    assert_close(stages[0]["dx"], x.grad.numpy(), 1e-6, "pipeline_apply input gradient")
    mlp_grads = {}
    for s in stages:
        for k, g in s["mlp_grads"].items():
            mlp_grads.setdefault(k, g)
    for k, p in mlp.named_parameters():
        assert_close(mlp_grads[k], p.grad.numpy(), 1e-6, f"mlp grad {k}")
