"""The port's Mamba on the grouped-scan route against the JAX package, on
the CPU: every bimamba type with `scan_impl="pallas"` (JAX `_fused_scan`
with its Pallas scan in interpret mode), and a d_state that is not a
multiple of 8 on the default route (which then leaves the megakernel, as in
JAX), with the JAX weights carried across by `mamba_pairs`; output and the
gradient of the input and of every parameter. Then the port's two routes
against each other from the same weights.

Tolerances, as max |port - jax| <= tol * (1 + max |jax|): 1e-4 in f32 (the
chunked TPU scan and the plain token-by-token scan sum in different
orders); the port's two routes 1e-5 (the same plain arithmetic grouped
differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.models.mamba import Mamba as JMamba
from mm_unet_tpu.utils.torch_convert import mamba_pairs
from mm_unet_tpu_torch.models.mamba import DIRECTIONS, Mamba
from mm_unet_tpu_torch.utils.convert import jax_grads_to_torch
from torch_port_harness import assert_close, load_torch, to_numpy

D_MODEL, L, NS = 8, 40, 5


def _pairs(bt):
    pairs = mamba_pairs((), "m", D_MODEL, dirs=DIRECTIONS["v3" if bt == "v1" else bt])
    return [(fp, tk[2:], kind) for fp, tk, kind in pairs]  # drop the "m." root


def _jax_case(bt, scan_impl, d_state, seed):
    """(variables, x, w, JAX out, grads of params, grad of x) as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, L, D_MODEL)).astype(np.float32)
    w = rng.standard_normal((2, L, D_MODEL)).astype(np.float32)
    jm = JMamba(d_model=D_MODEL, d_state=d_state, bimamba_type=bt, nslices=NS,
                scan_impl=scan_impl)
    variables = to_numpy(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))

    def loss(params, xj):
        out = jm.apply({"params": params}, xj)
        out = out[0] if isinstance(out, tuple) else out
        return jnp.sum(out * w), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(x))
    return variables, x, w, np.asarray(out), to_numpy(gp), np.asarray(gx)


@pytest.mark.parametrize("bt,scan_impl,d_state", [
    ("v3", "pallas", 16), ("v2", "pallas", 16), ("none", "pallas", 16), ("v1", "pallas", 16),
    ("v2", None, 12),  # d_state % 8 != 0: the default route is the grouped scan in both
])
def test_mamba_grouped_route_matches_jax(bt, scan_impl, d_state):
    variables, x, w, want, gp, gx = _jax_case(bt, scan_impl, d_state, seed=len(bt) + d_state)
    pairs = _pairs(bt)
    m = load_torch(Mamba(D_MODEL, d_state=d_state, bimamba_type=bt, nslices=NS,
                         scan_impl=scan_impl), variables, pairs)
    assert not m.use_mega and m.kernel_launches_per_forward() == {"selective_scan": 1}
    xt = torch.from_numpy(x).requires_grad_(True)
    res = m(xt)
    assert isinstance(res, tuple) == (bt in ("v3", "v1"))
    out = res[0] if isinstance(res, tuple) else res
    assert_close(out.detach().numpy(), want, 1e-4, f"{bt} out")
    (out * torch.from_numpy(w)).sum().backward()
    assert_close(xt.grad.numpy(), gx, 1e-4, f"{bt} dx")
    named = dict(m.named_parameters())
    want_g = jax_grads_to_torch(gp, pairs)
    assert set(want_g) == set(named)
    for k, g in want_g.items():
        assert_close(named[k].grad.numpy(), g.numpy(), 1e-4, f"{bt} grad {k}")


@pytest.mark.parametrize("bt", ["v3", "v2", "none"])
def test_mamba_routes_agree(bt):
    """The grouped-scan route and the megakernel route from the same
    weights: every return and every gradient."""
    m = Mamba(D_MODEL, bimamba_type=bt, nslices=NS, generator=torch.Generator().manual_seed(4))
    assert m.use_mega and m.kernel_launches_per_forward() == {
        "mamba_fused_scan": len(DIRECTIONS[bt])}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, L, D_MODEL)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, L, D_MODEL)).astype(np.float32))
    outs, grads = {}, {}
    for impl in (None, "pallas"):
        m.scan_impl = impl
        m.zero_grad()
        res = m(x)
        res = res if isinstance(res, tuple) else (res,)
        (res[0] * w).sum().backward()
        outs[impl] = [r.detach() for r in res]
        grads[impl] = {k: p.grad.clone() for k, p in m.named_parameters()}
    for a, b in zip(outs[None], outs["pallas"]):
        assert_close(b.numpy(), a.numpy(), 1e-5, f"{bt} returns")
    for k, g in grads[None].items():
        assert_close(grads["pallas"][k].numpy(), g.numpy(), 1e-5, f"{bt} grad {k}")
