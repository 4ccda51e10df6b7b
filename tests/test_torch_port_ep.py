"""The port's Switch mixture of experts and its expert parallelism
(`mm_unet_tpu_torch/parallel/ep.py`) against the JAX package's
`SwitchFFN`, on the CPU, with the JAX init's weights: the output, the
auxiliary load-balance loss and the gradients of sum(y * w) + aux at the
default capacity factor 1.25 and at 0.5, where tokens overflow their
expert's capacity and take the residual path (the count of dropped tokens
is the JAX module's). Then the experts split over 2 gloo ranks
(`shard_moe_params`): each rank holds 2 of the 4 experts, and the output,
aux and every gradient equal the unsplit module's.

Tolerances, as max |port - ref| <= tol * (1 + max |ref|): against JAX 1e-5
(the same products in another order), the split against the unsplit 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.parallel.ep import SwitchFFN as JSwitchFFN
from mm_unet_tpu.utils.torch_convert import dense_pairs
from mm_unet_tpu_torch.parallel.ep import SwitchFFN, ep_param_specs
from mm_unet_tpu_torch.utils.convert import jax_grads_to_torch, jax_to_torch_state_dict
from test_torch_port_ranks import EP, ep_ffn, ep_worker, run_ranks
from torch_port_harness import assert_close, to_numpy

PAIRS = dense_pairs(("router",), "router", bias=False) + [
    (("W1",), "W1", "raw"), (("W2",), "W2", "raw")]
CAPACITY = (1.25, 0.5)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, EP["d_model"])).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    v = to_numpy(JSwitchFFN(**EP).init(jax.random.key(0), jnp.asarray(x)))
    state = {k: t.numpy() for k, t in jax_to_torch_state_dict(
        v, PAIRS, like=SwitchFFN(**EP).state_dict()).items()}
    return x, w, v, state


def _dropped(x, router_w, capacity_factor):
    """Tokens past their expert's capacity, counted from the routing."""
    t = x.reshape(-1, x.shape[-1])
    choice = np.argmax(t @ router_w.T, axis=-1)
    cap = max(1, int(np.ceil(len(t) / EP["n_experts"] * capacity_factor)))
    return sum(max(0, int((choice == e).sum()) - cap) for e in range(EP["n_experts"]))


@pytest.mark.parametrize("cf", CAPACITY)
def test_switch_ffn_matches_jax(setup, cf):
    x, w, v, state = setup
    jm = JSwitchFFN(**EP, capacity_factor=cf)

    def loss(params, xj):
        y, aux = jm.apply({"params": params}, xj)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (want_y, want_aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    ffn = ep_ffn(state, cf)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = ffn(xt)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    assert_close(y.detach().numpy(), np.asarray(want_y), 1e-5, "y")
    assert_close(aux.item(), float(want_aux), 1e-5, "aux")
    assert_close(xt.grad.numpy(), np.asarray(gx), 1e-5, "dx")
    for k, g in jax_grads_to_torch(to_numpy(gp), PAIRS).items():
        assert_close(dict(ffn.named_parameters())[k].grad.numpy(), g.numpy(), 1e-5, f"d{k}")
    dropped = _dropped(x, state["router.weight"], cf)
    assert dropped > (4 if cf < 1 else -1)  # at 0.5, 8 slots for 16 tokens
    same = np.isclose(y.detach().numpy(), x, atol=1e-7).all(-1).sum()
    assert same >= dropped  # a dropped token passes through unchanged


def test_expert_split_equals_unsplit(setup, tmp_path):
    x, w, _, state = setup
    got = run_ranks(2, ep_worker, tmp_path, state, x, w, CAPACITY)
    for i, cf in enumerate(CAPACITY):
        ffn = ep_ffn(state, cf)
        xt = torch.from_numpy(x).requires_grad_()
        y, aux = ffn(xt)
        ((y * torch.from_numpy(w)).sum() + aux).backward()
        for r, res in enumerate(got):
            s = res[i]
            assert s["local_experts"] == 2
            assert_close(s["y"], y.detach().numpy(), 1e-6, f"y, rank {r}, cf {cf}")
            assert_close(s["aux"], aux.item(), 1e-6, f"aux, rank {r}")
            assert_close(s["dx"], xt.grad.numpy(), 1e-6, f"dx, rank {r}")
            for k, p in ffn.named_parameters():
                assert_close(s["grads"][k], p.grad.numpy(), 1e-6, f"d{k}, rank {r}, cf {cf}")
    assert ep_param_specs(SwitchFFN(**EP), 2) == {"router.weight": None, "W1": 0, "W2": 0}
    assert ep_param_specs(SwitchFFN(**EP), 3) == {"router.weight": None, "W1": None, "W2": None}
